"""The port's row-partitioned distributed layer against the JAX package's.

JAX runs ``binary_spgemm_tpu.parallel.dist_spgemm`` on ``make_row_mesh(S)``
over the conftest's virtual CPU devices; the port runs the same entry
points in S gloo ranks on the CPU (``parallel.launch``), once per S for
every case (module-scoped), each rank returning its result and its step
outputs.  For every case and S: the final ``BCSR`` on every rank is
bit-exact against JAX's and the scipy oracle, and each rank's prefix-fixed
row pointers, valid counts, index prefixes, total and sub-chunk bounds are
element-equal to JAX's shard of the same step (captured at each package's
assembly).  The host staging is compared field by field without ranks.
"""
import functools

import numpy as np
import pytest

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import spgemm as jx_sp
from binary_spgemm_tpu.parallel import dist_spgemm as jd
from binary_spgemm_tpu.parallel.mesh import make_row_mesh as jx_mesh
from binary_spgemm_tpu.parallel.mesh import partition_rows as jx_partition

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp
from binary_spgemm_tpu_torch.parallel import dist_spgemm as td
from binary_spgemm_tpu_torch.parallel.launch import launch
from binary_spgemm_tpu_torch.parallel.mesh import partition_rows
from binary_spgemm_tpu_torch.utils.oracle import (
    masked_spgemm_oracle,
    spgemm_oracle,
    union_oracle,
)

import _torch_dist_cases

SIZES = (1, 2, 4)
DIST = "binary_spgemm_tpu_torch.parallel.dist_spgemm"
ELL = "binary_spgemm_tpu_torch.ops.ell"
# n_cols 2^24 leaves a packed row cap of 32 rows a sub-chunk: 2400 rows give
# a shard past 16 packed sub-chunks at every S here (the batched plan)
WIDE = (2400, 1 << 24)


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def rnd(n, m, d, s):
    return jx.BCSR.random(n, m, d, seed=s)


def skewed(n, m, heavy, light, seed):
    """``heavy`` entries in row 0, ``light`` spread over the rows."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.zeros(heavy, int), rng.integers(0, n, light)])
    cols = rng.integers(0, m, heavy + light)
    return jx.BCSR.from_coo(rows, cols, (n, m))


def empty(n, m):
    return jx.BCSR(np.zeros(n + 1, np.int32), np.zeros(0, np.int32), (n, m))


def wide_pair():
    return rnd(WIDE[0], WIDE[0], 2.0, 3), rnd(WIDE[0], WIDE[1], 2.0, 4)


def dup_mask():
    return jx.BCSR.from_coo(np.array([0, 0, 1, 5, 5, 5]), np.array([3, 3, 7, 2, 2, 9]),
                            (100, 100))


def empty_class_b():
    return skewed(300, 300, 900, 400, 7)


# name -> (function, a maker of its operands, keyword arguments, oracle); the oracle
# takes the port operands.  The cases are tests/test_parallel.py's.
SPGEMM = lambda a, b: spgemm_oracle(a, b)  # noqa: E731
MASKED = lambda f, a, b: masked_spgemm_oracle(f, a, b)  # noqa: E731
UNION = lambda a, b: union_oracle(a, b)  # noqa: E731


def fused_oracle(d, a, b, mask=None):
    prod = spgemm_oracle(a, b) if mask is None else masked_spgemm_oracle(mask, a, b)
    return union_oracle(d, prod)


CASES = {
    "serial-flops-0": ("dist_spgemm", lambda: (rnd(400, 400, 4.0, 0),) * 2,
                       {"balance": "flops"}, SPGEMM),
    "serial-rows-1": ("dist_spgemm", lambda: (rnd(400, 400, 4.0, 1),) * 2,
                      {"balance": "rows"}, SPGEMM),
    "non-divisible": ("dist_spgemm", lambda: (rnd(397, 397, 3.0, 7),) * 2, {}, SPGEMM),
    "skewed": ("dist_spgemm", lambda: (skewed(500, 500, 2000, 1000, 0),) * 2, {}, SPGEMM),
    "rectangular": ("dist_spgemm", lambda: (rnd(300, 200, 3.0, 3), rnd(200, 450, 2.0, 4)),
                    {}, SPGEMM),
    "sharded-b": ("dist_spgemm", lambda: (rnd(400, 400, 4.0, 0),) * 2,
                  {"b_layout": "sharded"}, SPGEMM),
    "sharded-b-rect": ("dist_spgemm", lambda: (rnd(301, 203, 3.0, 5), rnd(203, 157, 2.0, 6)),
                       {"b_layout": "sharded"}, SPGEMM),
    "ring": ("dist_spgemm", lambda: (rnd(350, 350, 4.0, 3),) * 2, {"b_layout": "ring"},
             SPGEMM),
    "ring-rect": ("dist_spgemm", lambda: (rnd(123, 301, 3.0, 11), rnd(301, 203, 2.0, 12)),
                  {"b_layout": "ring"}, SPGEMM),
    "ring-skewed": ("dist_spgemm", lambda: (skewed(400, 400, 1500, 800, 5),) * 2,
                    {"b_layout": "ring"}, SPGEMM),
    **{
        f"matrix-{lay}-{eng}": ("dist_spgemm", lambda: (rnd(330, 330, 4.0, 19),) * 2,
                                {"b_layout": lay, "engine": eng}, SPGEMM)
        for lay in ("replicated", "sharded", "ring") for eng in ("esc", "ell")
    },
    "ring-ell-rmat": ("dist_spgemm", lambda: (jx.BCSR.rmat(9, 4.0, seed=23),) * 2,
                      {"b_layout": "ring", "engine": "ell"}, SPGEMM),
    "ring-ell-rect": ("dist_spgemm", lambda: (rnd(123, 301, 3.0, 24), rnd(301, 203, 2.0, 25)),
                      {"b_layout": "ring", "engine": "ell"}, SPGEMM),
    "empty-class-slices-sharded": (
        "dist_spgemm", lambda: (rnd(250, 300, 3.0, 26), empty_class_b()),
        {"b_layout": "sharded", "engine": "ell"}, SPGEMM),
    "empty-class-slices-ring": (
        "dist_spgemm", lambda: (rnd(250, 300, 3.0, 26), empty_class_b()),
        {"b_layout": "ring", "engine": "ell"}, SPGEMM),
    "ell-rmat": ("dist_spgemm", lambda: (jx.BCSR.rmat(9, 4.0, seed=2),) * 2,
                 {"engine": "ell"}, SPGEMM),
    "ell-rect": ("dist_spgemm", lambda: (rnd(123, 512, 3.0, 4), rnd(512, 300, 2.0, 3)),
                 {"engine": "ell"}, SPGEMM),
    "ell-many-chunks": ("dist_spgemm", lambda: (rnd(1200, 1200, 8.0, 17),) * 2,
                        {"engine": "ell"}, SPGEMM),
    "ell-batched": ("dist_spgemm", wide_pair, {"engine": "ell"}, SPGEMM),
    "empty-product": ("dist_spgemm", lambda: (rnd(50, 40, 2.0, 1), empty(40, 30)), {},
                      SPGEMM),
    "compact-pull-esc": ("dist_spgemm", lambda: (jx.BCSR.rmat(9, 4.0, seed=81),) * 2,
                         {"engine": "esc"}, SPGEMM),
    "compact-pull-ell": ("dist_spgemm", lambda: (jx.BCSR.rmat(9, 4.0, seed=81),) * 2,
                         {"engine": "ell"}, SPGEMM),
    **{
        f"masked-{eng}": ("dist_masked_spgemm",
                          lambda: (rnd(300, 300, 20.0, 32), rnd(300, 300, 4.0, 31),
                                   rnd(300, 300, 4.0, 31)),
                          {"engine": eng}, MASKED)
        for eng in ("esc", "ell", "auto")
    },
    **{
        f"masked-skewed-rect-{eng}": (
            "dist_masked_spgemm",
            lambda: (rnd(256, 120, 15.0, 35), jx.BCSR.rmat(8, 4.0, seed=33),
                     rnd(256, 120, 3.0, 34)),
            {"engine": eng}, MASKED)
        for eng in ("esc", "ell")
    },
    "masked-empty-mask": ("dist_masked_spgemm",
                          lambda: (empty(100, 100),) + (rnd(100, 100, 3.0, 36),) * 2, {},
                          MASKED),
    "masked-dup-mask": ("dist_masked_spgemm",
                        lambda: (dup_mask(),) + (rnd(100, 100, 3.0, 36),) * 2, {}, MASKED),
    "spm-or": ("dist_spm_or", lambda: (rnd(500, 230, 3.0, 51), rnd(500, 230, 2.0, 52)), {},
               UNION),
    "spm-or-skewed": ("dist_spm_or",
                      lambda: (skewed(500, 230, 2000, 0, 5), rnd(500, 230, 2.0, 52)), {},
                      UNION),
    **{
        f"or-{'masked' if masked else 'plain'}-{eng}": (
            "dist_spgemm_or",
            lambda masked=masked: (rnd(300, 300, 2.0, 54),) + (rnd(300, 300, 3.0, 53),) * 2
            + ((rnd(300, 300, 25.0, 55),) if masked else ()),
            {"engine": eng}, fused_oracle)
        for masked in (False, True) for eng in ("esc", "ell", "auto")
    },
    **{
        f"or-skewed-rect-{'masked' if masked else 'plain'}": (
            "dist_spgemm_or",
            lambda masked=masked: (rnd(256, 120, 2.0, 59), jx.BCSR.rmat(8, 4.0, seed=57),
                                   rnd(256, 120, 3.0, 58))
            + ((rnd(256, 120, 15.0, 60),) if masked else ()),
            {"engine": "ell"}, fused_oracle)
        for masked in (False, True)
    },
    "or-empty-product": ("dist_spgemm_or",
                         lambda: (rnd(50, 50, 2.0, 56),) + (empty(50, 50),) * 2, {},
                         fused_oracle),
}
# the fused-OR cases pass the mask by keyword
MASK_KW = {name for name, (fn, *_) in CASES.items() if fn == "dist_spgemm_or"}


def split_mask(name, ops):
    if name in MASK_KW and len(ops) == 4:
        return ops[:3], {"mask": ops[3]}
    return ops, {}


def guard_cap(n_shards):
    """``BATCHED_MAX_SLOTS`` one below the wide case's batched plan at
    ``n_shards`` shards, so the pre-staging guard re-plans it unrolled."""
    a, b = (to_port(m) for m in wide_pair())
    rf = tp_sp.row_flops(a, b)
    plan = td._shard_ell_operands(a, b, n_shards, partition_rows(rf, n_shards), rf,
                                  allow_batched=True)
    assert plan[-1]
    return plan[6] * (plan[7].shape[1] - 1) - 1


def port_cases(S):
    out = []
    for name, (fn, build, kw, _) in CASES.items():
        ops, extra = split_mask(name, tuple(to_port(m) for m in build()))
        out.append((name, DIST, fn, ops, {**kw, **extra, "device": "cpu"}, ()))
    ops = tuple(to_port(m) for m in wide_pair())
    out.append(("ell-batched-guard", DIST, "dist_spgemm", ops, {"engine": "ell"},
                ((ELL, "BATCHED_MAX_SLOTS", guard_cap(S)),)))
    return out


ALL_CASES = [*CASES, "ell-batched-guard"]


@pytest.fixture(scope="module")
def ranks():
    """S -> every rank's results of every case (one launch per S)."""
    cache = {}

    def get(S):
        if S not in cache:
            cache[S] = launch(_torch_dist_cases.run_cases, S, port_cases(S),
                             device="cpu", timeout=300)
        return cache[S]

    return get


@functools.lru_cache(maxsize=None)
def jax_run(name, S):
    """JAX's result of a case on ``make_row_mesh(S)``, with the step outputs
    its assembly received (normalised to ``[S, C, ...]``)."""
    import binary_spgemm_tpu.ops.ell as jx_ell

    if name == "ell-batched-guard":
        fn, build, kw = "dist_spgemm", wide_pair, {"engine": "ell"}
    else:
        fn, build, kw, _ = CASES[name]
    ops, extra = split_mask(name, build())
    steps = []
    sharded, subchunked = jd._assemble_sharded, jd._assemble_subchunked

    def rec(c_ptr, c_idx, nnz, total, sub_bounds):
        c_ptr, c_idx = np.asarray(c_ptr), np.asarray(c_idx)
        nnz = np.asarray(nnz).reshape(S, -1)
        steps.append({"c_ptr": c_ptr.reshape(S, nnz.shape[1], -1),
                      "c_idx": c_idx.reshape(S, nnz.shape[1], -1), "nnz": nnz,
                      "total": int(total), "sub_bounds": sub_bounds})

    def cap_sharded(c_ptr, c_idx, nnz, total, bounds, shape, c_cnt=None):
        rec(c_ptr, c_idx, nnz, total, np.stack([bounds[:-1], bounds[1:]], 1))
        return sharded(c_ptr, c_idx, nnz, total, bounds, shape, c_cnt)

    def cap_sub(c_ptr, c_idx, nnz, total, sub_bounds, shape, c_cnt=None):
        rec(c_ptr, c_idx, nnz, total, sub_bounds)
        return subchunked(c_ptr, c_idx, nnz, total, sub_bounds, shape, c_cnt)

    saved = [(jd, "_assemble_sharded", sharded), (jd, "_assemble_subchunked", subchunked),
             (jx_sp, "COMPACT_PULL_BYTES", jx_sp.COMPACT_PULL_BYTES),
             (jx_sp, "PULL_PAGE", jx_sp.PULL_PAGE),
             (jx_ell, "BATCHED_MAX_SLOTS", jx_ell.BATCHED_MAX_SLOTS)]
    jd._assemble_sharded, jd._assemble_subchunked = cap_sharded, cap_sub
    if name.startswith("compact-pull"):  # JAX's compact-before-pull, forced
        jx_sp.COMPACT_PULL_BYTES, jx_sp.PULL_PAGE = 0, 1 << 10
    if name == "ell-batched-guard":
        jx_ell.BATCHED_MAX_SLOTS = guard_cap(S)
    try:
        c = getattr(jd, fn)(*ops, mesh=jx_mesh(S), **kw, **extra)
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)
    return c, steps


def oracle(name):
    if name == "ell-batched-guard":
        name = "ell-batched"
    fn, build, _, want = CASES[name]
    ops, extra = split_mask(name, tuple(to_port(m) for m in build()))
    return want(*ops, **extra)


# the cases whose steps are also held against JAX's at S = 2 (one a path
# of the JAX package's dryrun); every case's are at S = 4
STEPS_AT_2 = {*(f"matrix-{lay}-{eng}" for lay in ("replicated", "sharded", "ring")
                for eng in ("esc", "ell")),
              "masked-esc", "masked-ell", "or-plain-auto", "or-masked-auto", "spm-or",
              "ell-batched", "ell-batched-guard"}


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("name", ALL_CASES)
def test_dist_case_matches_jax_and_scipy(name, S, ranks):
    """Every rank's final BCSR is bit-exact against JAX's and scipy's, and
    each rank's step outputs are element-equal to JAX's shard of them at
    S = 4 (and at S = 2 for one case a path).  Elsewhere JAX's result is its
    4-device one: the result does not depend on S."""
    got = ranks(S)
    assert len(got) == S
    steps_too = S == 4 or (S == 2 and name in STEPS_AT_2)
    c_jax, jax_steps = jax_run(name, S if steps_too else 4)
    want = oracle(name)
    assert to_port(c_jax).equals(want)
    for r, res in enumerate(got):
        c = res[name]["c"]
        assert c.equals(want), f"rank {r}: {c.diff(want)}"
        if not steps_too:
            assert all(p["total"] == want.nnz for p in res[name]["steps"])
            continue
        assert len(res[name]["steps"]) == len(jax_steps)
        for p, j in zip(res[name]["steps"], jax_steps):
            assert np.array_equal(p["sub_bounds"], j["sub_bounds"])
            assert np.array_equal(p["c_ptr"], j["c_ptr"][r])
            assert np.array_equal(p["nnz"], j["nnz"][r])
            assert (p["total"] - j["total"]) % (1 << 32) == 0
            for c_, idx in enumerate(p["idx"]):
                assert np.array_equal(idx, j["c_idx"][r, c_, : j["nnz"][r, c_]])


def test_batched_plans_are_taken():
    """The wide case plans batched at every S, and the guard case re-plans
    unrolled (the plans the batched cases above are meant to drive)."""
    a, b = (to_port(m) for m in wide_pair())
    rf = tp_sp.row_flops(a, b)
    for S in SIZES:
        bounds = partition_rows(rf, S)
        plan = td._shard_ell_operands(a, b, S, bounds, rf, allow_batched=True)
        assert plan[-1] and tp_sp.packable(plan[5], b.n_cols)
        assert td._shard_ell_operands(a, b, S, bounds, rf)[-1] is False


def pair_streams(k, L, n_rows, n_cols, seed):
    """``[k, L]`` candidate pairs with repeats and ``(n_rows, n_cols)``
    sentinels, as an expansion makes them."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n_rows, (k, L)).astype(np.int32)
    col = rng.integers(0, min(n_cols, 64), (k, L)).astype(np.int32)
    sent = rng.random((k, L)) < 0.2
    row[sent], col[sent] = n_rows, n_cols
    return row, col


@pytest.mark.parametrize("L", [128, 129, 4096, 4097, 32768, 32769])
@pytest.mark.parametrize("packed", [True, False])
def test_sort_compress_2d_matches_jax(L, packed):
    """``sort_compress_2d`` (and ``sort_compress_2d_keys`` on packed keys)
    element-equal to the JAX package's on whole outputs, on both sides of
    128, 4,096 and 32,768 slots a row (K1's variant bounds and its window
    on the card)."""
    import jax.numpy as jnp
    import torch

    from binary_spgemm_tpu.ops.spgemm import sort_compress_2d, sort_compress_2d_keys

    n_rows, n_cols = (50, 300) if packed else (50, 1 << 26)
    assert tp_sp.packable(n_rows, n_cols) == packed
    row, col = pair_streams(3, L, n_rows, n_cols, L)
    want = sort_compress_2d(jnp.asarray(row), jnp.asarray(col), n_rows, n_cols)
    got = tp_sp.sort_compress_2d(torch.from_numpy(row), torch.from_numpy(col), n_rows,
                                 n_cols)
    outs = [(got, want)]
    if packed:
        key = (row << n_cols.bit_length()) | col
        outs.append((tp_sp.sort_compress_2d_keys(torch.from_numpy(key), n_rows, n_cols),
                     sort_compress_2d_keys(jnp.asarray(key), n_rows, n_cols)))
    for g, w in outs:
        for x, y in zip(g, w):
            assert x.dtype == torch.int32
            same(x.numpy(), y)


# ---------------------------------------------------------------------------
# Host staging, field by field (no ranks)
# ---------------------------------------------------------------------------


def test_partition_rows_modes():
    w = np.array([100, 1, 1, 1, 1, 1, 1, 1])
    assert partition_rows(w, 4, balance="rows").tolist() == [0, 2, 4, 6, 8]
    flops = partition_rows(w, 4, balance="flops")
    assert flops[0] == 0 and flops[-1] == 8 and flops[1] == 1
    assert partition_rows(np.zeros(8, int), 4).tolist() == [0, 2, 4, 6, 8]
    with pytest.raises(ValueError, match="balance"):
        partition_rows(w, 4, balance="nnz")
    rng = np.random.default_rng(3)
    for S in (1, 2, 3, 4, 8):
        for weights in (rng.integers(0, 50, 97), rng.zipf(2.0, 300)):
            for balance in ("rows", "flops"):
                assert np.array_equal(partition_rows(weights, S, balance=balance),
                                      jx_partition(weights, S, balance=balance))


def stage_inputs():
    return [(rnd(400, 400, 4.0, 0),) * 2, (skewed(500, 500, 2000, 1000, 0),) * 2,
            (rnd(123, 301, 3.0, 11), rnd(301, 203, 2.0, 12)),
            (rnd(250, 300, 3.0, 26), empty_class_b()), (jx.BCSR.rmat(9, 4.0, seed=23),) * 2]


def same(x, y):
    assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("S", SIZES)
def test_esc_staging_matches_jax(S):
    for ja, jb in stage_inputs():
        a, b = to_port(ja), to_port(jb)
        ops, jops = td.shard_operands(a, b, S), jd.shard_operands(ja, jb, jx_mesh(S))
        for f in ("bounds", "a_ptr", "a_idx", "a_nnz", "b_ptr", "b_idx"):
            same(getattr(ops, f), getattr(jops, f))
        assert (ops.rows_pad, ops.flops_pad, ops.shape) == (
            jops.rows_pad, jops.flops_pad, tuple(jops.shape))
        p, i, m_per = td.shard_b_operands(b, S)
        jp, ji, jm_per = jd.shard_b_operands(jb, jx_mesh(S))
        same(p, jp), same(i, ji)
        assert m_per == jm_per
        assert td.ring_step_pad(a, b, ops.bounds, m_per, S) == jd.ring_step_pad(
            ja, jb, jops.bounds, jm_per, S)
        for side in (ja, jx.BCSR.random(a.n_rows, b.n_cols, 2.0, seed=9)):
            for x, y in zip(td._shard_rows_csr(to_port(side), ops.bounds, ops.rows_pad),
                            jd._shard_rows_csr(side, jops.bounds, jops.rows_pad,
                                               jx_mesh(S))):
                same(x, y)


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("layout", ["replicated", "sharded"])
def test_ell_staging_matches_jax(S, layout):
    """Every field of the ELL plan (widths, pads, rows_pad, sort_pad,
    sub_bounds, batched, tables and entry arrays) equals JAX's, with and
    without the join's extra key bits; and the side operands' sub-chunk
    staging."""
    inputs = stage_inputs() + [(rnd(1200, 1200, 8.0, 17),) * 2]
    for ja, jb in inputs:
        a, b = to_port(ja), to_port(jb)
        rf = tp_sp.row_flops(a, b)
        bounds = partition_rows(rf, S)
        for bits in (0, 1, 2):
            kw = dict(b_tables=layout, extra_key_bits=bits, allow_batched=bits == 0)
            got = td._shard_ell_operands(a, b, S, bounds, rf, **kw)
            want = jd._shard_ell_operands(ja, jb, jx_mesh(S), bounds, rf, **kw)
            for x, y in zip(got[0], want[0]):
                same(x, y)
            for k in (1, 2):
                assert len(got[k]) == len(want[k])
                for x, y in zip(got[k], want[k]):
                    same(x, y)
            assert got[3:7] == want[3:7]
            same(got[7], want[7])
            assert got[8] == want[8]
        f = jx.BCSR.random(a.n_rows, b.n_cols, 3.0, seed=4)
        for x, y in zip(td._shard_ell_csr(to_port(f), got[7], got[5]),
                        jd._shard_ell_csr(f, got[7], got[5], jx_mesh(S))):
            same(x, y)


@pytest.mark.parametrize("S", SIZES)
def test_ring_ell_staging_matches_jax(S):
    for ja, jb in stage_inputs():
        a, b = to_port(ja), to_port(jb)
        bounds = partition_rows(tp_sp.row_flops(a, b), S)
        got = td._shard_ring_ell_operands(a, b, S, bounds)
        want = jd._shard_ring_ell_operands(ja, jb, jx_mesh(S), bounds)
        for k in (0, 1, 2):
            for x, y in zip(got[k], want[k]):
                same(x, y)
        assert got[3:] == want[3:]


def test_balanced_chunk_bounds_match_jax():
    rng = np.random.default_rng(11)
    for rf in (rng.integers(0, 1000, 5000), rng.zipf(1.5, 3000) % 100000,
               np.zeros(100, np.int64)):
        for budget, max_rows in ((1 << 12, 4096), (1 << 14, 128), (1 << 19, 1 << 20)):
            assert td._balanced_chunk_bounds(rf, budget, max_rows) == (
                jd._balanced_chunk_bounds(rf, budget, max_rows))


def test_errors_match_jax():
    a = tp.BCSR.random(16, 16, 1.0, seed=0)
    b = tp.BCSR.random(8, 8, 1.0, seed=0)
    for call, match in (
        (lambda: td.dist_spgemm(a, a, b_layout="scattered", device="cpu"), "b_layout"),
        (lambda: td.dist_spgemm(a, a, engine="dense", device="cpu"), "engine"),
        (lambda: td.dist_spgemm(a, b, device="cpu"), "shape mismatch"),
        (lambda: td.dist_masked_spgemm(b, a, a, device="cpu"), "shape mismatch"),
        (lambda: td.dist_spm_or(a, b, device="cpu"), "shape mismatch"),
        (lambda: td.dist_spgemm_or(a, a, a, mask=b, device="cpu"), "mask shape"),
    ):
        with pytest.raises(ValueError, match=match):
            call()


def test_one_process_without_a_group():
    """With no process group the mesh is this process alone: the products
    run on its device, equal to scipy's, and more ranks raise."""
    from binary_spgemm_tpu_torch.parallel.mesh import make_row_mesh

    mesh = make_row_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.backend) == (None, 0, 1, None)
    a = tp.BCSR.random(200, 200, 3.0, seed=2)
    for lay in ("replicated", "sharded", "ring"):
        assert td.dist_spgemm(a, a, b_layout=lay, device="cpu").equals(
            spgemm_oracle(a, a))
    with pytest.raises(RuntimeError, match="no process group"):
        make_row_mesh(2, device="cpu")


def test_pointer_fix_wraps_as_int32():
    """Past 2^31 entries the prefix-fixed int32 pointers wrap as JAX's do;
    sub-chunk-local differences (what assembly reads, in uint32) stay
    exact."""
    import torch

    from binary_spgemm_tpu_torch.parallel.mesh import make_row_mesh

    big = (1 << 31) - 8
    ptr = torch.tensor([[0, 5, big], [0, 50, 100]], dtype=torch.int32)
    nnz = torch.tensor([big, 100], dtype=torch.int32)
    step = td._ptr_fix(ptr, torch.zeros((2, 1), dtype=torch.int32), nnz,
                       make_row_mesh(device="cpu"))
    assert step.total == big + 100
    fixed = step.c_ptr.numpy().view(np.uint32).astype(np.int64)
    assert fixed.tolist() == [[0, 5, big], [big, big + 50, big + 100]]
    assert int(step.c_ptr[1, 2]) < 0  # the int32 view wrapped


def test_launcher_surfaces_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch(_torch_dist_cases.raise_on_rank, 2, 1, device="cpu", timeout=60)


def test_launcher_kills_a_hung_group():
    with pytest.raises(TimeoutError, match="ran past"):
        launch(_torch_dist_cases.sleep_forever, 2, device="cpu", timeout=3)


def test_collectives_and_counters():
    """Each rank's mesh and collectives: a gather, a host gather and one
    ring step in rank order, their calls and bytes counted, nothing staged
    on the CPU (gloo moves host tensors)."""
    S = 3
    facts = launch(_torch_dist_cases.mesh_facts, S, device="cpu", timeout=120)
    bounds = partition_rows(np.ones(100), S)
    for r, f in enumerate(facts):
        assert (f["rank"], f["size"], f["backend"], f["global"]) == (r, S, "gloo", (r, S))
        assert f["device"] == "cpu"
        assert f["range"] == (int(bounds[r]), int(bounds[r + 1]))
        assert np.array_equal(f["gathered"], np.repeat(np.arange(S), 3).reshape(S, 3))
        assert np.array_equal(f["summed"], np.full(3, S * (S - 1) // 2))
        assert np.array_equal(f["ring"], np.full(3, (r - 1) % S))
        assert f["counters"] == {"calls": 3, "bytes": 36, "staged_bytes": 0}
