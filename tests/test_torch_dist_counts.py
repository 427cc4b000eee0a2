"""The port's distributed counting family and triangle count against the JAX
package's.

JAX runs ``binary_spgemm_tpu.parallel.dist_spgemm``'s ``dist_spgemm_counts``,
``dist_masked_spgemm_counts`` and ``dist_triangle_count`` on
``make_row_mesh(S)`` over the conftest's virtual CPU devices; the port runs
the same entry points in S gloo ranks on the CPU (``parallel.launch``), one
launch per S for every case (module-scoped).  For every case and S, on every
rank: the ``BCSR`` is bit-exact against JAX's and scipy's, the counts equal
JAX's and scipy's int64 product, and each rank's step (prefix-fixed
pointers, valid counts, index prefixes and counts payload) is element-equal
to JAX's shard of it, captured at each package's assembly; the triangle
count equals JAX's, scipy's ``G.multiply(G @ G).sum() // 6`` and the port's
single-device ``triangle_count_device``.
"""
import functools

import numpy as np
import pytest

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.parallel import dist_spgemm as jd
from binary_spgemm_tpu.parallel.mesh import make_row_mesh as jx_mesh

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import counts as tp_counts
from binary_spgemm_tpu_torch.parallel import comm
from binary_spgemm_tpu_torch.parallel import dist_spgemm as td
from binary_spgemm_tpu_torch.parallel.launch import launch
from binary_spgemm_tpu_torch.parallel.mesh import make_row_mesh

import _torch_dist_cases

SIZES = (1, 2, 4)
DIST = "binary_spgemm_tpu_torch.parallel.dist_spgemm"
# n_cols 2^24: the product's wide-column case (the batched plan in
# dist_spgemm; the counting plans, never batched, go unpacked there)
WIDE = (2400, 1 << 24)


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def rnd(n, m, d, s):
    return jx.BCSR.random(n, m, d, seed=s)


def empty(n, m):
    return jx.BCSR(np.zeros(n + 1, np.int32), np.zeros(0, np.int32), (n, m))


def dup(n, seed):
    """A square operand with repeated entries (they must not inflate the
    counts)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, 6 * n)
    cols = rng.integers(0, n, 6 * n)
    return jx.BCSR.from_coo(np.concatenate([rows, rows[:n]]),
                            np.concatenate([cols, cols[:n]]), (n, n))


def wide_mask():
    """A mask for the wide-column product: every other entry of the
    product, and as many entries off it."""
    a, b = rnd(WIDE[0], WIDE[0], 2.0, 3), rnd(WIDE[0], WIDE[1], 2.0, 4)
    p = (a.to_scipy() @ b.to_scipy()).tocoo()
    rng = np.random.default_rng(6)
    rows = np.concatenate([p.row[::2], rng.integers(0, WIDE[0], p.nnz // 2)])
    cols = np.concatenate([p.col[::2], rng.integers(0, WIDE[1], p.nnz // 2)])
    return jx.BCSR.from_coo(rows, cols, (WIDE[0], WIDE[1])).sum_duplicates(), a, b


def sym(m):
    """The symmetric adjacency with an empty diagonal made from ``m``."""
    s = m.to_scipy()
    s = ((s + s.T) > 0).astype(np.int64).tolil()
    s.setdiag(0)
    s = s.tocsr()
    s.eliminate_zeros()
    s.sort_indices()
    return jx.BCSR(s.indptr.astype(np.int32), s.indices.astype(np.int32), s.shape)


# name -> (function, a maker of its operands, keyword arguments)
CASES = {
    **{f"counts-{eng}": ("dist_spgemm_counts", lambda: (rnd(300, 300, 4.0, 31),) * 2,
                         {"engine": eng}) for eng in ("esc", "ell", "auto")},
    **{f"counts-rect-{eng}": ("dist_spgemm_counts",
                              lambda: (rnd(123, 301, 3.0, 11), rnd(301, 203, 2.0, 12)),
                              {"engine": eng}) for eng in ("esc", "ell")},
    "counts-rmat-ell": ("dist_spgemm_counts", lambda: (jx.BCSR.rmat(9, 4.0, seed=2),) * 2,
                        {"engine": "ell"}),
    "counts-many-chunks-ell": ("dist_spgemm_counts", lambda: (rnd(1200, 1200, 8.0, 17),) * 2,
                               {"engine": "ell"}),
    "counts-wide-ell": ("dist_spgemm_counts",
                        lambda: (rnd(WIDE[0], WIDE[0], 2.0, 3), rnd(WIDE[0], WIDE[1], 2.0, 4)),
                        {"engine": "ell"}),
    "counts-rows-balance": ("dist_spgemm_counts", lambda: (rnd(400, 400, 4.0, 1),) * 2,
                            {"balance": "rows"}),
    "counts-duplicates": ("dist_spgemm_counts", lambda: (dup(200, 5),) * 2, {}),
    "counts-empty": ("dist_spgemm_counts", lambda: (rnd(50, 40, 2.0, 1), empty(40, 30)), {}),
    **{f"masked-{eng}": ("dist_masked_spgemm_counts",
                         lambda: (rnd(300, 300, 20.0, 32),) + (rnd(300, 300, 4.0, 31),) * 2,
                         {"engine": eng}) for eng in ("esc", "ell", "auto")},
    **{f"masked-skewed-rect-{eng}": (
        "dist_masked_spgemm_counts",
        lambda: (rnd(256, 120, 15.0, 35), jx.BCSR.rmat(8, 4.0, seed=33), rnd(256, 120, 3.0, 34)),
        {"engine": eng}) for eng in ("esc", "ell")},
    "masked-wide-ell": ("dist_masked_spgemm_counts", wide_mask, {"engine": "ell"}),
    "masked-edges": ("dist_masked_spgemm_counts",
                     lambda: (sym(rnd(300, 300, 4.0, 36)),) * 3, {}),
    "masked-empty-mask": ("dist_masked_spgemm_counts",
                          lambda: (empty(100, 100),) + (rnd(100, 100, 3.0, 36),) * 2, {}),
}
TRIANGLES = {
    **{f"triangles-{eng}": (lambda: sym(rnd(300, 300, 4.0, 31)), {"engine": eng})
       for eng in ("esc", "ell", "auto")},
    **{f"triangles-rmat-{eng}": (lambda: sym(jx.BCSR.rmat(9, 6.0, seed=7)), {"engine": eng})
       for eng in ("esc", "ell")},
    "triangles-rows-balance": (lambda: sym(rnd(333, 333, 5.0, 8)), {"balance": "rows"}),
    "triangles-empty": (lambda: empty(60, 60), {}),
}


def port_cases():
    out = [(name, DIST, fn, tuple(to_port(m) for m in build()), {**kw, "device": "cpu"}, ())
           for name, (fn, build, kw) in CASES.items()]
    out += [(name, DIST, "dist_triangle_count", (to_port(build()),),
             {**kw, "device": "cpu"}, ()) for name, (build, kw) in TRIANGLES.items()]
    # a directed graph: its wedge sum is not divisible by 6
    directed = tp.BCSR.from_dense(np.triu(~np.eye(4, dtype=bool)))
    out += [(f"triangles-directed-{eng}", DIST, "dist_triangle_count", (directed,),
             {"engine": eng, "device": "cpu"}, ()) for eng in ("esc", "ell")]
    out.append(("all-reduce", "_torch_dist_cases", "reduce_facts", (), {}, ()))
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
    """JAX's ``(c, counts)`` of a case on ``make_row_mesh(S)``, with the
    step outputs its assembly received (normalised to ``[S, C, ...]``)."""
    fn, build, kw = CASES[name]
    steps = []
    sharded, subchunked = jd._assemble_sharded, jd._assemble_subchunked

    def rec(c_ptr, c_idx, c_cnt, nnz, total, sub_bounds):
        nnz = np.asarray(nnz).reshape(S, -1)
        C = nnz.shape[1]
        steps.append({"c_ptr": np.asarray(c_ptr).reshape(S, C, -1),
                      "c_idx": np.asarray(c_idx).reshape(S, C, -1),
                      "c_cnt": np.asarray(c_cnt).reshape(S, C, -1), "nnz": nnz,
                      "total": int(total), "sub_bounds": sub_bounds})

    def cap_sharded(c_ptr, c_idx, nnz, total, bounds, shape, c_cnt=None):
        rec(c_ptr, c_idx, c_cnt, nnz, total, np.stack([bounds[:-1], bounds[1:]], 1))
        return sharded(c_ptr, c_idx, nnz, total, bounds, shape, c_cnt)

    def cap_sub(c_ptr, c_idx, nnz, total, sub_bounds, shape, c_cnt=None):
        rec(c_ptr, c_idx, c_cnt, nnz, total, sub_bounds)
        return subchunked(c_ptr, c_idx, nnz, total, sub_bounds, shape, c_cnt)

    jd._assemble_sharded, jd._assemble_subchunked = cap_sharded, cap_sub
    try:
        c, counts = getattr(jd, fn)(*build(), mesh=jx_mesh(S), **kw)
    finally:
        jd._assemble_sharded, jd._assemble_subchunked = sharded, subchunked
    return c, counts, steps


def int_oracle(name):
    """scipy's int64 product (F .* (A·B) for the masked cases), sorted, its
    explicit zeros dropped."""
    fn, build, _ = CASES[name]
    ops = [m.sum_duplicates() for m in build()]
    f, (a, b) = (ops[0], ops[1:]) if fn == "dist_masked_spgemm_counts" else (None, ops)
    want = a.to_scipy().astype(np.int64) @ b.to_scipy().astype(np.int64)
    if f is not None:
        want = want.multiply(f.to_scipy().astype(np.int64)).tocsr()
    want.sort_indices()
    want.eliminate_zeros()
    return want


def assert_counts(c, counts, want, where=""):
    assert np.array_equal(np.asarray(c.indptr, np.int64), want.indptr), where
    assert np.array_equal(c.indices, want.indices), where
    assert counts.dtype == np.int64 and np.array_equal(counts, want.data), where


# the cases whose steps are held against JAX's at every S; every case's are
# at S = 4 (JAX compiles each case and S anew: the suite stays short)
STEPS_AT_ALL_S = {"counts-esc", "counts-ell", "counts-wide-ell", "masked-esc", "masked-ell",
                  "masked-wide-ell"}


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("name", list(CASES))
def test_dist_counts_match_jax_and_scipy(name, S, ranks):
    """Every rank's ``(c, counts)`` is bit-exact against JAX's and scipy's,
    and its step element-equal to JAX's shard (pointers, valid counts,
    index prefixes and the counts payload) at S = 4, and at every S for
    the cases of :data:`STEPS_AT_ALL_S`.  Elsewhere JAX's result is its
    4-device one: the result does not depend on S."""
    got = ranks(S)
    steps_too = S == 4 or name in STEPS_AT_ALL_S
    c_jax, cnt_jax, jax_steps = jax_run(name, S if steps_too else 4)
    want = int_oracle(name)
    assert_counts(c_jax, cnt_jax, want, "jax")
    for r, res in enumerate(got):
        c, counts = res[name]["c"]
        assert_counts(c, counts, want, f"rank {r}")
        assert c.equals(to_port(c_jax)) and np.array_equal(counts, cnt_jax)
        if not steps_too:
            assert all(p["total"] == want.nnz for p in res[name]["steps"])
            continue
        assert len(res[name]["steps"]) == len(jax_steps)
        for p, j in zip(res[name]["steps"], jax_steps):
            assert np.array_equal(p["sub_bounds"], j["sub_bounds"])
            assert np.array_equal(p["c_ptr"], j["c_ptr"][r])
            assert np.array_equal(p["nnz"], j["nnz"][r])
            assert (p["total"] - j["total"]) % (1 << 32) == 0
            for c_, (idx, cnt) in enumerate(zip(p["idx"], p["cnt"])):
                n_c = j["nnz"][r, c_]
                assert np.array_equal(idx, j["c_idx"][r, c_, :n_c])
                assert cnt.dtype == np.int32 and np.array_equal(cnt, j["c_cnt"][r, c_, :n_c])


@functools.lru_cache(maxsize=None)
def jax_triangles(name, S):
    build, kw = TRIANGLES[name]
    return jd.dist_triangle_count(build(), jx_mesh(S), **kw)


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("name", list(TRIANGLES))
def test_dist_triangle_count_matches_jax_and_scipy(name, S, ranks):
    """Every rank returns JAX's count (on as many devices for the two
    engines' main cases, else on 4), scipy's and the single-device
    ``triangle_count_device``'s (the group's int64 total over 6)."""
    build, _ = TRIANGLES[name]
    g = build()
    s = g.to_scipy().astype(np.int64)
    want = int(s.multiply(s @ s).sum()) // 6
    same_s = name in ("triangles-esc", "triangles-ell")
    assert jax_triangles(name, S if same_s else 4) == want
    assert tp_counts.triangle_count_device(to_port(g), device="cpu") == want
    if name != "triangles-empty":
        assert want > 0
    assert [res[name]["c"] for res in ranks(S)] == [want] * S


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("eng", ["esc", "ell"])
def test_dist_triangle_count_rejects_a_directed_graph(eng, S, ranks):
    for res in ranks(S):
        assert res[f"triangles-directed-{eng}"]["error"].startswith("ValueError: ")
        assert "symmetric" in res[f"triangles-directed-{eng}"]["error"]


def test_triangle_total_equals_jax_limbs(monkeypatch):
    """The wedge sum one all-reduce returns equals JAX's two int32 limbs,
    ``(hi << 15) + lo``, on both engines' steps."""
    g = sym(rnd(300, 300, 4.0, 31))
    t = to_port(g)
    mesh = make_row_mesh(device="cpu")
    for eng in ("esc", "ell"):
        got = {}

        def keep(total, _got=got):
            _got["total"] = total
            return total // 6

        monkeypatch.setattr(td, "_triangles", keep)
        td.dist_triangle_count(t, mesh, engine=eng)
        s = g.to_scipy().astype(np.int64)
        assert got["total"] == int(s.multiply(s @ s).sum())
    ops = jd.shard_operands(g, g, jx_mesh(1))
    f_ptr, f_idx, _ = jd._shard_rows_csr(g, ops.bounds, ops.rows_pad, ops.mesh)
    hi, lo = jd.dist_triangle_sum_sharded(
        ops.a_ptr, ops.a_idx, ops.a_nnz, f_ptr, f_idx, ops.b_ptr, ops.b_idx,
        mesh=ops.mesh, n_cols=g.n_cols, flops_pad=ops.flops_pad)
    assert (int(hi) << 15) + int(lo) == got["total"]


@pytest.mark.parametrize("S", SIZES)
def test_all_reduce_sum_over_ranks(S, ranks):
    """``comm.all_reduce_sum`` adds every rank's int64 past 2^32, leaves
    each rank's input as it was, and counts one call of 16 bytes (gloo on
    the host: nothing staged)."""
    want = np.array([S * (S - 1) // 2, S * (1 << 40) + S * (S - 1) // 2])
    for r, res in enumerate(ranks(S)):
        f = res["all-reduce"]["c"]
        assert np.array_equal(f["sum"], want)
        assert np.array_equal(f["input"], [r, (1 << 40) + r])
        assert f["counters"] == {"calls": 1, "bytes": 16, "staged_bytes": 0}


def test_all_reduce_sum_alone_and_its_type():
    import torch

    mesh = make_row_mesh(device="cpu")
    x = torch.tensor([5, 7], dtype=torch.int64)
    comm.reset_counters()
    assert comm.all_reduce_sum(x, mesh) is x
    assert comm.counters["calls"] == 0
    with pytest.raises(TypeError, match="int64"):
        comm.all_reduce_sum(x.to(torch.int32), mesh)


def test_counting_errors_match_jax():
    """The shape, engine and square-matrix checks raise ``ValueError`` as
    JAX's do, before any rank work."""
    a = tp.BCSR.random(16, 16, 1.0, seed=0)
    b = tp.BCSR.random(8, 8, 1.0, seed=0)
    r = tp.BCSR.random(16, 8, 1.0, seed=0)
    ja, jb, jr = (jx.BCSR.random(*m.shape, 1.0, seed=0) for m in (a, b, r))
    for call, jcall, match in (
        (lambda: td.dist_spgemm_counts(a, b, device="cpu"),
         lambda: jd.dist_spgemm_counts(ja, jb, jx_mesh(1)), "shape mismatch"),
        (lambda: td.dist_spgemm_counts(a, a, engine="dense", device="cpu"),
         lambda: jd.dist_spgemm_counts(ja, ja, jx_mesh(1), engine="dense"), "engine"),
        (lambda: td.dist_masked_spgemm_counts(b, a, a, device="cpu"),
         lambda: jd.dist_masked_spgemm_counts(jb, ja, ja, jx_mesh(1)), "shape mismatch"),
        (lambda: td.dist_masked_spgemm_counts(a, a, a, engine="x", device="cpu"),
         lambda: jd.dist_masked_spgemm_counts(ja, ja, ja, jx_mesh(1), engine="x"),
         "engine"),
        (lambda: td.dist_triangle_count(r, device="cpu"),
         lambda: jd.dist_triangle_count(jr, jx_mesh(1)), "square"),
        (lambda: td.dist_triangle_count(a, engine="x", device="cpu"),
         lambda: jd.dist_triangle_count(ja, jx_mesh(1), engine="x"), "engine"),
    ):
        with pytest.raises(ValueError, match=match):
            call()
        with pytest.raises(ValueError, match=match):
            jcall()


def test_counting_entry_points_default_to_the_card():
    """Without ``device=`` the counting ops run on the card: with none,
    they raise instead of falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    a = tp.BCSR.random(50, 50, 2.0, seed=1)
    for call in (lambda: td.dist_spgemm_counts(a, a),
                 lambda: td.dist_masked_spgemm_counts(a, a, a),
                 lambda: td.dist_triangle_count(to_port(sym(rnd(50, 50, 2.0, 1))))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
