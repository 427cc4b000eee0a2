"""The port's distributed one-sort closure and k-hop against the JAX
package's, the host routes and scipy.

JAX runs ``binary_spgemm_tpu.parallel.dist_onesort`` on ``make_row_mesh(S)``
over the conftest's virtual CPU devices; the port runs the same entry points
in S gloo ranks on the CPU (``parallel.launch``), one launch per S for every
case (module-scoped).  Every rank's result is bit-exact against JAX's, the
port's single-device ``transitive_closure`` / ``k_hop`` and scipy's, and the
one-sort state each rank hands its final pull (the stream with its holes,
the positional pointers, the valid count) is element-equal to JAX's shard of
it.

The one exception is the reference's: JAX's ``_dist_bound`` offsets the
gathered pointers of Y by X's stream length, so a product of streams of
different lengths (``dist_k_hop`` at k = 3, 5) gets a short flop pad and
JAX drops candidates there.  The port's bound uses Y's length; it is held
against JAX only at k = 1, 2, 4, and :func:`test_jax_k_hop_drops_entries_at_3_and_5`
shows the entries JAX's A^3 and A^5 lack.
"""
import functools

import numpy as np
import pytest

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.parallel import dist_onesort as jdo
from binary_spgemm_tpu.parallel.mesh import make_row_mesh as jx_mesh

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import graph as tp_graph
from binary_spgemm_tpu_torch.parallel import dist_onesort as tdo
from binary_spgemm_tpu_torch.parallel.launch import launch
from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle, union_oracle

import _torch_dist_cases

SIZES = (1, 2, 4)
MOD = "binary_spgemm_tpu_torch.parallel.dist_onesort"
# the k-hop input (JAX's A^3 and A^5 lack entries at 2 and 4 devices) and
# the powers the tests take
KHOP = (123, 2.0, 12)
KS = (1, 2, 3, 4, 5)
JAX_EXACT_KS = (1, 2, 4)  # no product there joins streams of different lengths


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def rnd(n, d, s):
    return jx.BCSR.random(n, n, d, seed=s).sum_duplicates()


def khop_input():
    n, d, s = KHOP
    return rnd(n, d, s)


# name -> (a maker of the input, keyword arguments, patches (attribute, value)
# on both packages' dist_onesort modules)
CLOSURES = {
    "closure-243": (lambda: rnd(243, 1.2, 9), {}, ()),  # 243 rows: no S > 1 divides them
    "closure-chain": (lambda: jx.BCSR.from_coo(np.arange(47), np.arange(1, 48), (48, 48)),
                      {}, ()),
    "closure-max-iters-1": (lambda: rnd(120, 1.0, 7), {"max_iters": 1}, ()),
    "closure-compact-every-round": (lambda: rnd(160, 1.5, 6), {},
                                    (("ONESORT_COMPACT_RATIO", 0.0),)),
}


def port_cases():
    out = [(name, MOD, "dist_transitive_closure", (to_port(build()),),
            {**kw, "device": "cpu"}, tuple((MOD, k, v) for k, v in patches))
           for name, (build, kw, patches) in CLOSURES.items()]
    a = to_port(khop_input())
    out += [(f"k_hop-{k}", MOD, "dist_k_hop", (a,), {"k": k, "device": "cpu"}, ())
            for k in KS]
    big = to_port(jx.BCSR.random(500, 500, 4.0, seed=8).sum_duplicates())
    out += [("closure-overflow", MOD, "dist_transitive_closure", (big,), {"device": "cpu"},
             ((MOD, "DEVICE_CLOSURE_MAX_FLOPS", 100),))]
    return out


@pytest.fixture(scope="module")
def ranks():
    """S -> every rank's results of every case (one launch per S)."""
    cache = {}

    def get(S):
        if S not in cache:
            cache[S] = launch(_torch_dist_cases.run_cases, S, port_cases(), device="cpu",
                              timeout=300)
        return cache[S]

    return get


@functools.lru_cache(maxsize=None)
def jax_run(name, S):
    """JAX's result of a case on ``make_row_mesh(S)`` and the sharded state
    its final pull received (``[S, ...]`` arrays)."""
    pulls = []
    pull = jdo._pull

    def capture(cols, pos, *rest):
        pulls.append({"cols": np.asarray(cols), "pos": np.asarray(pos)})
        return pull(cols, pos, *rest)

    saved = [(jdo, "_pull", pull)]
    if name.startswith("k_hop"):
        call = functools.partial(jdo.dist_k_hop, khop_input(), jx_mesh(S),
                                 int(name.split("-")[1]))
    else:
        build, kw, patches = CLOSURES[name]
        saved += [(jdo, k, getattr(jdo, k)) for k, _ in patches]
        for k, v in patches:
            setattr(jdo, k, v)
        call = functools.partial(jdo.dist_transitive_closure, build(), jx_mesh(S), **kw)
    jdo._pull = capture
    try:
        c = call()
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)
    return c, pulls


def closure_oracle(a, max_iters=None):
    """scipy's doubling rounds R <- R OR R·R to the fixpoint (or
    ``max_iters`` rounds)."""
    r = a
    for _ in range(max_iters if max_iters is not None else max(1, a.n_rows.bit_length())):
        nxt = union_oracle(r, spgemm_oracle(r, r))
        if nxt.equals(r):
            break
        r = nxt
    return r


def khop_oracle(a, k):
    r = a
    for _ in range(k - 1):
        r = spgemm_oracle(r, a)
    return r


# the closures whose pulled state is also held against JAX's at S = 1 and 2;
# every closure's is at S = 4
STATES_AT_ALL_S = {"closure-chain"}


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("name", list(CLOSURES))
def test_dist_closure_matches_jax_host_and_scipy(name, S, ranks):
    """Every rank's closure is bit-exact against JAX's, the port's host
    route and scipy's doubling rounds; the state each rank pulls is
    element-equal to JAX's shard at S = 4 (and at every S for the cases of
    :data:`STATES_AT_ALL_S`).  Elsewhere JAX's result is its 4-device one:
    the result does not depend on S (JAX compiles each round's shape anew,
    so the cheaper comparison keeps the suite short)."""
    build, kw, _ = CLOSURES[name]
    a = to_port(build())
    want = closure_oracle(a, kw.get("max_iters"))
    assert tp_graph.transitive_closure(a, device="cpu", **kw).equals(want)
    states_too = S == 4 or name in STATES_AT_ALL_S
    c_jax, jax_pulls = jax_run(name, S if states_too else 4)
    assert to_port(c_jax).equals(want)
    for r, res in enumerate(ranks(S)):
        got = res[name]
        assert got["c"].equals(want), f"rank {r}: {got['c'].diff(want)}"
        assert len(got["pulls"]) == len(jax_pulls) == 1
        n_pad = -(-a.n_rows // S) * S
        assert int(got["pulls"][0]["nnz"]) == int((got["pulls"][0]["cols"] < n_pad).sum())
        if states_too:
            for key in ("cols", "pos"):
                assert np.array_equal(got["pulls"][0][key], jax_pulls[0][key][r]), (r, key)


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("k", KS)
def test_dist_k_hop_matches_host_and_scipy(k, S, ranks):
    """A^k on every rank equals host ``k_hop``, the one-sort resident route
    and scipy at every k; JAX's at k = 1, 2, 4 (with the state each rank
    pulls, at S = 4 and, for k = 2, at every S)."""
    a = to_port(khop_input())
    want = khop_oracle(a, k)
    assert tp_graph.k_hop(a, k, device="cpu").equals(want)
    assert tp_graph.k_hop(a, k, resident=True, device="cpu").equals(want)
    for r, res in enumerate(ranks(S)):
        got = res[f"k_hop-{k}"]
        assert got["c"].equals(want), f"rank {r}: {got['c'].diff(want)}"
        if k in JAX_EXACT_KS and (S == 4 or k == 2):
            c_jax, jax_pulls = jax_run(f"k_hop-{k}", S)
            assert to_port(c_jax).equals(want)
            for key in ("cols", "pos"):
                assert np.array_equal(got["pulls"][0][key], jax_pulls[0][key][r]), (r, key)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("k", [3, 5])
def test_jax_k_hop_drops_entries_at_3_and_5(k, S, ranks):
    """The reference's fault, which the port does not copy: in JAX's
    ``dist_k_hop(a, mesh, 3)`` the product A · A² joins A's stream with
    A²'s longer one, its bound offsets A²'s gathered pointers by A's length,
    and the expansion drops candidates (A^5 = A · A^4 likewise).  JAX's
    result is a strict subset of scipy's; the port's equals it."""
    a = to_port(khop_input())
    want = khop_oracle(a, k)
    c_jax, _ = jax_run(f"k_hop-{k}", S)
    jax_s, want_s = to_port(c_jax).to_scipy(), want.to_scipy()
    assert c_jax.nnz < want.nnz
    assert (jax_s - jax_s.multiply(want_s)).nnz == 0  # nothing JAX keeps is wrong
    for res in ranks(S):
        assert res[f"k_hop-{k}"]["c"].equals(want)


@pytest.mark.parametrize("S", SIZES)
def test_dist_closure_overflow_guard(S, ranks):
    """A per-rank budget patched down to 100 flops raises ``OverflowError``
    on every rank (all read the same largest bound), as JAX's does."""
    for res in ranks(S):
        assert res["closure-overflow"]["error"].startswith("OverflowError: ")
    a = jx.BCSR.random(500, 500, 4.0, seed=8).sum_duplicates()
    saved = jdo.DEVICE_CLOSURE_MAX_FLOPS
    jdo.DEVICE_CLOSURE_MAX_FLOPS = 100
    try:
        with pytest.raises(OverflowError):
            jdo.dist_transitive_closure(a, jx_mesh(S))
    finally:
        jdo.DEVICE_CLOSURE_MAX_FLOPS = saved


@pytest.mark.parametrize("S", SIZES)
def test_compaction_keeps_one_stream_length_on_every_rank(S, ranks):
    """Compacted every round (ratio 0), every rank's stream still has one
    length: the compaction's pad is the largest rank's count."""
    res = ranks(S)
    lengths = {r["closure-compact-every-round"]["pulls"][0]["cols"].shape[0] for r in res}
    assert len(lengths) == 1


def test_one_process_without_a_group():
    """With no process group the closure and k-hop run in this process
    alone (the collectives exchange nothing): the default rounds, one round,
    a compaction after every round, and A^3."""
    a = to_port(rnd(120, 1.5, 9))
    want = closure_oracle(a)
    assert tdo.dist_transitive_closure(a, device="cpu").equals(want)
    assert tdo.dist_transitive_closure(a, max_iters=1, device="cpu").equals(
        closure_oracle(a, 1))
    saved = tdo.ONESORT_COMPACT_RATIO
    tdo.ONESORT_COMPACT_RATIO = 0.0
    try:
        assert tdo.dist_transitive_closure(a, device="cpu").equals(want)
    finally:
        tdo.ONESORT_COMPACT_RATIO = saved
    assert tdo.dist_k_hop(a, None, 3, device="cpu").equals(khop_oracle(a, 3))


def test_bound_offsets_by_the_second_streams_length():
    """``_dist_bound`` of X·Y offsets the gathered pointers by Y's stream
    length: the bound equals the candidates the expansion makes, where
    X's and Y's streams differ in length (the k = 3 product)."""
    from binary_spgemm_tpu_torch.ops.onesort import _expand_from_padded
    from binary_spgemm_tpu_torch.parallel.mesh import make_row_mesh

    mesh = make_row_mesh(device="cpu")
    a = to_port(khop_input())
    n = a.n_rows
    x = tdo._stage(a, mesh, n, n)
    y = tdo._stage(spgemm_oracle(a, a), mesh, n, n)
    assert x[0].shape[0] != y[0].shape[0]
    bound = int(tdo._dist_bound(x[0], y[1], y[0].shape[0], mesh, n)[0])
    row, _ = _expand_from_padded(x[0], x[1], y[0], y[1], n_cols=n, flops_pad=bound)
    assert int((row < n).sum()) == bound
    with pytest.raises(ValueError, match="below the product"):
        _expand_from_padded(x[0], x[1], y[0], y[1], n_cols=n, flops_pad=bound - 1)


def test_validation_matches_jax():
    a = to_port(rnd(60, 2.0, 13))
    rect = tp.BCSR.random(40, 60, 2.0, seed=14)
    ja, jrect = rnd(60, 2.0, 13), jx.BCSR.random(40, 60, 2.0, seed=14)
    for call, jcall, match in (
        (lambda: tdo.dist_k_hop(a, None, 0, device="cpu"),
         lambda: jdo.dist_k_hop(ja, jx_mesh(2), 0), "k must be"),
        (lambda: tdo.dist_k_hop(rect, None, 2, device="cpu"),
         lambda: jdo.dist_k_hop(jrect, jx_mesh(2), 2), "square"),
        (lambda: tdo.dist_transitive_closure(rect, device="cpu"),
         lambda: jdo.dist_transitive_closure(jrect, jx_mesh(2)), "square"),
    ):
        with pytest.raises(ValueError, match=match):
            call()
        with pytest.raises(ValueError, match=match):
            jcall()


def test_entry_points_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    a = to_port(rnd(60, 2.0, 13))
    for call in (lambda: tdo.dist_transitive_closure(a), lambda: tdo.dist_k_hop(a, None, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_dryrun_lists_the_jax_dryruns_19_paths(capsys):
    """``python -m binary_spgemm_tpu_torch.parallel.dryrun 2 --device cpu``
    prints every path of the JAX dryrun's record (``MULTICHIP_r05.json``),
    in its order, each OK on both ranks."""
    import json
    import os

    from binary_spgemm_tpu_torch.parallel import dryrun

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "MULTICHIP_r05.json")) as fh:
        record = json.load(fh)["tail"].splitlines()
    jax_paths = [line.strip().rsplit(": ", 1)[0] for line in record
                 if line.startswith("  ") and line.endswith(": OK")]
    assert len(jax_paths) == 19 and list(dryrun.PATHS) == jax_paths
    assert dryrun.main(["2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line for line in out if line.startswith("  ")] == [f"  {p}: OK" for p in jax_paths]
    assert out[-1].startswith("dryrun OK: 2 ranks (gloo, cpu)") and "19 paths" in out[-1]
