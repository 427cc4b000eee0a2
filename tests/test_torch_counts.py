"""The port's counting family against the JAX package's, on the CPU: the
counts compression and the masked counts join and sum (packed and general,
1-D and batched, element-equal over their valid prefixes), the run marks,
and ``spgemm_counts``, ``masked_spgemm_counts`` and ``triangle_count_device``
on every route (host, chunked ESC, batched ELL, unrolled contiguous and
dealt ELL), each bit-exact against the JAX package and scipy's integer
product."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import counts as jx_counts
from binary_spgemm_tpu.ops import ell as jx_ell

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import counts as tp_counts
from binary_spgemm_tpu_torch.ops import ell as tp_ell
from binary_spgemm_tpu_torch.ops import host as tp_host
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def t_(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def j_(*xs):
    return [jnp.asarray(x) for x in xs]


def int_oracle(a, b):
    """scipy's int64 product, indices sorted."""
    c = a.to_scipy().astype(np.int64) @ b.to_scipy().astype(np.int64)
    c.sort_indices()
    return c


def masked_int_oracle(f, a, b):
    c = int_oracle(a, b).multiply(f.to_scipy().astype(np.int64)).tocsr()
    c.sort_indices()
    c.eliminate_zeros()
    return c


def assert_counts(got, ref):
    """``(BCSR, counts)`` equal to a scipy integer matrix."""
    c, counts = got
    assert counts.dtype == np.int64
    assert np.array_equal(c.indptr, ref.indptr)
    assert np.array_equal(c.indices, ref.indices)
    assert np.array_equal(counts, ref.data)


def assert_same_counts(j, t):
    assert np.array_equal(j[0].indptr, t[0].indptr)
    assert np.array_equal(j[0].indices, t[0].indices)
    assert np.array_equal(np.asarray(j[1]), t[1])


def stream_case(n_rows, n_cols, L, seed, k=None, seps=False):
    """Candidate pairs with repeats (multiplicities up to ~8), an ``(n_rows,
    n_cols)`` sentinel tail and, with ``seps``, one separator per row; with
    ``k`` a ``[k, L]`` stack."""
    rng = np.random.default_rng(seed)
    shape = (L,) if k is None else (k, L)
    pool = L // 8
    prow = rng.integers(0, n_rows, pool)
    pcol = rng.integers(0, n_cols, pool)
    pick = rng.integers(0, pool, shape)
    row, col = prow[pick].astype(np.int32), pcol[pick].astype(np.int32)
    tail = L // 8
    row[..., -tail:], col[..., -tail:] = n_rows, n_cols
    if seps:
        s = min(n_rows, L // 8)
        row[..., -tail - s : -tail] = np.arange(s)
        col[..., -tail - s : -tail] = n_cols
    return row, col


def mask_case(row, col, n_rows, n_cols, P, seed):
    """Canonical mask pairs, half of them drawn from the candidates, padded
    with ``(n_rows, n_cols)`` past the valid ones; returns ``(f_row, f_col,
    f_nnz)`` per stream."""
    rng = np.random.default_rng(seed)
    rows2, cols2 = np.atleast_2d(row), np.atleast_2d(col)
    fr, fc, nz = [], [], []
    for r, c in zip(rows2, cols2):
        live = np.flatnonzero((r < n_rows) & (c < n_cols))
        take = rng.choice(live, min(P // 2, len(live)), replace=False)
        keys = np.concatenate([r[take].astype(np.int64) * n_cols + c[take],
                               rng.integers(0, n_rows * n_cols, P // 2)])
        keys = np.unique(keys)[: P - 3]
        f_row = np.full(P, n_rows, np.int32)
        f_col = np.full(P, n_cols, np.int32)
        f_row[: len(keys)], f_col[: len(keys)] = keys // n_cols, keys % n_cols
        fr.append(f_row)
        fc.append(f_col)
        nz.append(len(keys))
    if np.ndim(row) == 1:
        return fr[0], fc[0], nz[0]
    return np.stack(fr), np.stack(fc), np.array(nz)


def prefix_equal(j, t, nnz):
    """Stacked (or 1-D) streams equal over each row's first ``nnz`` slots."""
    j, t = np.atleast_2d(np.asarray(j)), np.atleast_2d(t.numpy())
    assert j.shape == t.shape
    for r, n in enumerate(np.atleast_1d(nnz)):
        assert np.array_equal(j[r, :n], t[r, :n])


# packed with the histogram (37 rows) and the searchsorted (6) row pointers,
# packed for the plain key but not the masked one ((1 << 19) - 1 rows), and
# the general forms (2^29 columns)
STREAM_CASES = [(37, 53), (6, 53), ((1 << 19) - 1, 1023), (37, 1 << 29), (6, 1 << 29)]


@pytest.mark.parametrize("n_rows,n_cols", STREAM_CASES)
def test_sort_compress_counts_matches_jax(n_rows, n_cols):
    row, col = stream_case(n_rows, n_cols, 240, n_rows + 1)
    j = jx_counts.sort_compress_counts(*j_(row, col), n_rows, n_cols)
    t = tp_counts.sort_compress_counts(*t_(row, col), n_rows, n_cols)
    nnz = int(j[3])
    assert int(t[3]) == nnz and t[2].dtype == torch.int32
    assert np.array_equal(np.asarray(j[0]), t[0].numpy())
    prefix_equal(j[1], t[1], nnz)
    prefix_equal(j[2], t[2], nnz)
    assert not t[2][nnz:].any()  # demoted slots count 0
    # against the definition
    keys, counts = np.unique(row[row < n_rows].astype(np.int64) * n_cols
                             + col[row < n_rows], return_counts=True)
    assert nnz == len(keys) and np.array_equal(t[2][:nnz].numpy(), counts)


@pytest.mark.parametrize("n_rows,n_cols", STREAM_CASES)
def test_sort_compress_counts_seps_2d_matches_jax(n_rows, n_cols):
    row, col = stream_case(n_rows, n_cols, 200, n_rows + 2, k=5, seps=True)
    j_idx, j_cnt, j_nnz = (np.asarray(x) for x in jx_counts.sort_compress_counts_seps_2d(
        *j_(row, col), n_rows, n_cols))
    outs = [tp_counts.sort_compress_counts_seps_2d(*t_(row, col), n_rows, n_cols)]
    if tp_sp.packable(n_rows, n_cols):
        key = (row << int(n_cols).bit_length()) | col
        j_k = jx_counts.sort_compress_counts_seps_2d_keys(jnp.asarray(key), n_rows, n_cols)
        assert np.array_equal(np.asarray(j_k[2]), j_nnz)
        outs.append(tp_counts.sort_compress_counts_seps_2d_keys(
            torch.from_numpy(key), n_rows, n_cols))
    for t_idx, t_cnt, t_nnz in outs:
        assert np.array_equal(t_nnz.numpy(), j_nnz)
        prefix_equal(j_idx, t_idx, j_nnz)
        prefix_equal(j_cnt, t_cnt, j_nnz)
        # each separator survives with a count of 1
        for r, n in enumerate(j_nnz):
            seps = t_idx[r, :n] == n_cols
            assert seps.sum() == min(n_rows, 25) and (t_cnt[r, :n][seps] == 1).all()


@pytest.mark.parametrize("n_rows,n_cols", STREAM_CASES)
def test_masked_counts_compress_matches_jax(n_rows, n_cols):
    row, col = stream_case(n_rows, n_cols, 240, n_rows + 3)
    f_row, f_col, f_nnz = mask_case(row, col, n_rows, n_cols, 64, n_rows + 4)
    f_ptr = np.searchsorted(f_row[:f_nnz], np.arange(n_rows + 1)).astype(np.int32)
    j = jx_counts.masked_counts_compress(*j_(row, col, f_ptr, f_col), jnp.int32(f_nnz),
                                         n_rows, n_cols)
    t = tp_counts.masked_counts_compress(*t_(row, col, f_ptr, f_col), f_nnz,
                                         n_rows, n_cols)
    nnz = int(j[3])
    assert int(t[3]) == nnz and t[1].shape == (len(row) + len(f_col),)
    assert np.array_equal(np.asarray(j[0]), t[0].numpy())
    prefix_equal(j[1], t[1], nnz)
    prefix_equal(j[2], t[2], nnz)
    fset = set((f_row[:f_nnz].astype(np.int64) * n_cols + f_col[:f_nnz]).tolist())
    keys, counts = np.unique(row[row < n_rows].astype(np.int64) * n_cols
                             + col[row < n_rows], return_counts=True)
    hit = np.array([k in fset for k in keys.tolist()], bool)
    assert nnz == hit.sum() and np.array_equal(t[2][:nnz].numpy(), counts[hit])


@pytest.mark.parametrize("n_rows,n_cols", STREAM_CASES)
def test_masked_counts_compress_seps_2d_matches_jax(n_rows, n_cols):
    row, col = stream_case(n_rows, n_cols, 200, n_rows + 5, k=4, seps=True)
    f_row, f_col, _ = mask_case(row, col, n_rows, n_cols, 48, n_rows + 6)
    j_idx, j_cnt, j_nnz = (np.asarray(x) for x in jx_counts.masked_counts_compress_seps_2d(
        *j_(row, col, f_row, f_col), n_rows, n_cols))
    outs = [tp_counts.masked_counts_compress_seps_2d(*t_(row, col, f_row, f_col),
                                                     n_rows, n_cols)]
    if tp_sp.packable(n_rows, 2 * n_cols + 1):
        key = (row << int(n_cols).bit_length()) | col
        j_k = jx_counts.masked_counts_compress_seps_2d_keys(*j_(key, f_row, f_col),
                                                            n_rows, n_cols)
        assert np.array_equal(np.asarray(j_k[2]), j_nnz)
        outs.append(tp_counts.masked_counts_compress_seps_2d_keys(
            *t_(key, f_row, f_col), n_rows, n_cols))
    for t_idx, t_cnt, t_nnz in outs:
        assert t_idx.shape == j_idx.shape and np.array_equal(t_nnz.numpy(), j_nnz)
        prefix_equal(j_idx, t_idx, j_nnz)
        prefix_equal(j_cnt, t_cnt, j_nnz)


@pytest.mark.parametrize("n_rows,n_cols", STREAM_CASES)
def test_masked_counts_sum_matches_jax(n_rows, n_cols):
    row, col = stream_case(n_rows, n_cols, 2400, n_rows + 7, k=3, seps=True)
    f_row, f_col, _ = mask_case(row, col, n_rows, n_cols, 300, n_rows + 8)
    j = np.asarray(jx_counts.masked_counts_sum_2d(*j_(row, col, f_row, f_col),
                                                  n_rows, n_cols))
    t = tp_counts.masked_counts_sum_2d(*t_(row, col, f_row, f_col), n_rows, n_cols)
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), j)
    if tp_sp.packable(n_rows, 2 * n_cols + 1):
        key = (row << int(n_cols).bit_length()) | col
        t_k = tp_counts.masked_counts_sum_2d_keys(*t_(key, f_row, f_col), n_rows, n_cols)
        assert np.array_equal(t_k.numpy(), j)
    # the 1-D form on the first stream, against the definition
    f_nnz = int((f_row[0] < n_rows).sum())
    f_ptr = np.searchsorted(f_row[0, :f_nnz], np.arange(n_rows + 1)).astype(np.int32)
    one = tp_counts.masked_counts_sum(*t_(row[0], col[0], f_ptr, f_col[0]), f_nnz,
                                      n_rows, n_cols)
    j1 = jx_counts.masked_counts_sum(*j_(row[0], col[0], f_ptr, f_col[0]),
                                     jnp.int32(f_nnz), n_rows, n_cols)
    assert int(one) == int(j1) == j[0]
    # the definition; a separator (r, n_cols) is no mask pair
    fset = set(zip(f_row[0, :f_nnz].tolist(), f_col[0, :f_nnz].tolist()))
    assert j[0] == sum(p in fset for p in zip(row[0].tolist(), col[0].tolist()))


@pytest.mark.parametrize("n", [6, 3000])
def test_masked_run_marks_match_jax(n):
    """The run marks are two running maxima over plain positions; past
    1,024 slots the port's scan runs by segments (``_running_max``)."""
    rng = np.random.default_rng(n)
    if n == 6:  # runs [mask, cand], [cand], [mask, cand, cand]
        is_mask = np.array([1, 0, 0, 1, 0, 0], bool)
        new = np.array([1, 0, 1, 1, 0, 0], bool)
    else:
        is_mask, new = rng.random(n) < 0.2, rng.random(n) < 0.1
        new[0] = False  # a leading slot with no run start
    t = tp_counts._masked_run_marks(*t_(is_mask, new))
    j = jx_counts._masked_run_marks_1d(*j_(is_mask, new))
    assert np.array_equal(t.numpy(), np.asarray(j))
    if n == 6:
        assert t.tolist() == [True, True, False, True, True, True]
    stack = np.stack([is_mask, ~is_mask]), np.stack([new, new])
    j2 = jx_counts._masked_run_marks_2d(*j_(*stack))
    assert np.array_equal(tp_counts._masked_run_marks(*t_(*stack)).numpy(), np.asarray(j2))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def record_routes(monkeypatch):
    """Record which engine each counting entry point took."""
    taken = []
    real_host = tp_host.host_spgemm_counts
    monkeypatch.setattr(tp_host, "host_spgemm_counts",
                        lambda *a: taken.append("host") or real_host(*a))
    for name in ("run_counts", "run_masked_counts", "run_counts_sum"):
        real = getattr(tp_ell.EllSpGEMMExecutor, name)

        def run(self, *args, _real=real):
            taken.append("batched" if self.batched else
                         "dealt" if self.row_sets is not None else "unrolled")
            return _real(self, *args)

        monkeypatch.setattr(tp_ell.EllSpGEMMExecutor, name, run)
    for name in ("_counts_padded", "_masked_counts_padded", "_masked_counts_sum_padded"):
        real = getattr(tp_counts, name)
        monkeypatch.setattr(tp_counts, name,
                            lambda *a, _real=real, **k: taken.append("esc") or _real(*a, **k))
    return taken


# route: (n, d, keywords); "batched" forces prefer_batched as the JAX tests do
ROUTES = {
    "host": (500, 3.0, {}),
    "unrolled": (9000, 16.0, {}),
    "batched": (9000, 16.0, {}),
    "esc": (3000, 4.0, {"chunk_flops": 5000}),
    "esc-general": (1000, 3.0, {"chunk_flops": 4000}),
}


def route_operands(monkeypatch, route, masked):
    n, d, kw = ROUTES[route]
    m = 1 << 22 if route == "esc-general" else n
    a = jx.BCSR.random(n, n, d, seed=41)
    b = jx.BCSR.random(n, m, d, seed=42)
    f = jx.BCSR.random(a.n_rows, b.n_cols, 3 * d, seed=44)
    if route == "batched":
        for mod in (jx_ell, tp_ell):
            monkeypatch.setattr(mod, "prefer_batched", lambda a, b: True)
    if masked and route == "host":
        kw = {"chunk_flops": 1 << 20}  # masked counts have no host route: ESC
    return a, b, f, kw


@pytest.mark.parametrize("route", list(ROUTES))
def test_spgemm_counts_routes(monkeypatch, route):
    a, b, _, kw = route_operands(monkeypatch, route, masked=False)
    taken = record_routes(monkeypatch)
    ta, tb = to_port(a), to_port(b)
    got = tp.spgemm_counts(ta, tb, device="cpu", **kw)
    assert taken and set(taken) == {route.split("-")[0]}
    assert_same_counts(jx.spgemm_counts(a, b, **kw), got)
    assert_counts(got, int_oracle(ta, tb))
    assert int(got[1].sum()) == tp.spgemm_flops(ta, tb)


@pytest.mark.parametrize("route", [r for r in ROUTES if r != "host"])
def test_masked_spgemm_counts_routes(monkeypatch, route):
    a, b, f, kw = route_operands(monkeypatch, route, masked=True)
    taken = record_routes(monkeypatch)
    ta, tb, tf = to_port(a), to_port(b), to_port(f)
    got = tp.masked_spgemm_counts(tf, ta, tb, device="cpu", **kw)
    assert taken and set(taken) == {route.split("-")[0]}
    assert_same_counts(jx.masked_spgemm_counts(f, a, b, **kw), got)
    assert_counts(got, masked_int_oracle(tf, ta, tb))


def sym_graph(n, d, seed):
    """A symmetric adjacency with an empty diagonal (the JAX tests')."""
    s = tp.BCSR.random(n, n, d, seed=seed).to_scipy()
    s = ((s + s.T) > 0).astype(np.int64).tolil()
    s.setdiag(0)
    return tp.BCSR.from_scipy(s.tocsr())


def triangles_oracle(g):
    s = g.to_scipy()
    return int(s.multiply(s @ s).sum()) // 6


@pytest.mark.parametrize("route", ["unrolled", "batched", "esc"])
def test_triangle_count_device_routes(monkeypatch, route):
    g = sym_graph(3000 if route == "batched" else 400, 5.0, 46)
    if route == "batched":
        for mod in (jx_ell, tp_ell):
            monkeypatch.setattr(mod, "prefer_batched", lambda a, b: True)
    kw = {"chunk_flops": 4096} if route == "esc" else {}
    taken = record_routes(monkeypatch)
    got = tp_counts.triangle_count_device(g, device="cpu", **kw)
    assert taken and set(taken) == {route}
    jg = jx.BCSR(g.indptr, g.indices, g.shape)
    assert got == jx_counts.triangle_count_device(jg, **kw) == triangles_oracle(g)
    assert got > 0


def test_counts_empty_and_duplicate_operands():
    e = tp.BCSR(np.zeros(5, np.int32), np.zeros(0, np.int32), (4, 4))
    c, counts = tp.spgemm_counts(e, e, device="cpu")
    assert c.nnz == 0 and counts.size == 0 and counts.dtype == np.int64
    a = tp.BCSR.random(10, 10, 2.0, seed=1)
    f = tp.BCSR(np.zeros(11, np.int32), np.zeros(0, np.int32), (10, 10))
    c, counts = tp.masked_spgemm_counts(f, a, a, device="cpu")
    assert c.nnz == 0 and counts.size == 0
    assert tp_counts.triangle_count_device(e, device="cpu") == 0
    # duplicate operand entries do not inflate the multiplicities, on any route
    dup = tp.BCSR.from_coo(np.array([0, 0, 1, 1, 1]), np.array([1, 1, 0, 2, 2]), (3, 3))
    eye = tp.BCSR.from_dense(np.eye(3))
    ref = int_oracle(dup.sum_duplicates(), eye)
    for kw in ({}, {"engine": "ell"}, {"chunk_flops": 64}):
        c, counts = tp.spgemm_counts(dup, eye, device="cpu", **kw)
        assert counts.max() == 1 and np.array_equal(counts, ref.data)
        c, counts = tp.masked_spgemm_counts(dup, dup, eye, device="cpu", **kw)
        assert np.array_equal(counts, masked_int_oracle(dup.sum_duplicates(),
                                                        dup.sum_duplicates(), eye).data)
    jdup = jx.BCSR(dup.indptr, dup.indices, dup.shape)
    assert_same_counts(jx.spgemm_counts(jdup, jx.BCSR(eye.indptr, eye.indices, eye.shape)),
                       tp.spgemm_counts(dup, eye, device="cpu"))


def test_counts_engine_errors():
    a = tp.BCSR.random(60, 60, 3.0, seed=11)
    auto_c, auto_v = tp.spgemm_counts(a, a, device="cpu")
    for kw in ({"engine": "ell"}, {"engine": "esc", "chunk_flops": 200}, {"engine": "esc"}):
        c, v = tp.spgemm_counts(a, a, device="cpu", **kw)
        assert c.equals(auto_c) and np.array_equal(v, auto_v)
    m_auto, mv_auto = tp.masked_spgemm_counts(a, a, a, device="cpu")
    m_ell, mv_ell = tp.masked_spgemm_counts(a, a, a, engine="ell", device="cpu")
    assert m_ell.equals(m_auto) and np.array_equal(mv_ell, mv_auto)
    for fn in (lambda **k: tp.spgemm_counts(a, a, device="cpu", **k),
               lambda **k: tp.masked_spgemm_counts(a, a, a, device="cpu", **k)):
        with pytest.raises(ValueError, match="unknown engine"):
            fn(engine="bogus")
        with pytest.raises(ValueError, match="mutually exclusive"):
            fn(engine="ell", chunk_flops=100)
    with pytest.raises(ValueError, match="shape mismatch"):
        tp.spgemm_counts(a, tp.BCSR.random(59, 60, 1.0, seed=1), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        tp.masked_spgemm_counts(tp.BCSR.random(60, 59, 1.0, seed=1), a, a, device="cpu")
    with pytest.raises(ValueError, match="square"):
        tp_counts.triangle_count_device(tp.BCSR.random(60, 59, 1.0, seed=1), device="cpu")


def test_counts_on_cuda_raise_without_a_card():
    """The entry points default to the card; without one they raise past the
    host route instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    a = tp.BCSR.random(9000, 9000, 16.0, seed=3)  # past the host route
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.spgemm_counts(a, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.spgemm_counts(a, a, chunk_flops=1 << 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.masked_spgemm_counts(a, a, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp_counts.triangle_count_device(sym_graph(300, 4.0, 1))


def test_triangle_count_k4_c4_and_asymmetric():
    k4 = tp.BCSR.from_dense(~np.eye(4, dtype=bool))
    c4 = np.zeros((4, 4), bool)
    for i in range(4):
        c4[i, (i + 1) % 4] = c4[(i + 1) % 4, i] = True
    for kw in ({}, {"chunk_flops": 64}):
        assert tp_counts.triangle_count_device(k4, device="cpu", **kw) == 4
        assert tp_counts.triangle_count_device(tp.BCSR.from_dense(c4), device="cpu",
                                               **kw) == 0
        directed = tp.BCSR.from_dense(np.triu(~np.eye(4, dtype=bool)))
        with pytest.raises(ValueError, match="symmetric"):
            tp_counts.triangle_count_device(directed, device="cpu", **kw)


def test_host_spgemm_counts_matches_jax():
    from binary_spgemm_tpu.ops.host import host_spgemm_counts

    a, b = jx.BCSR.random(400, 300, 4.0, seed=2), jx.BCSR.random(300, 500, 4.0, seed=3)
    got = tp.host_spgemm_counts(to_port(a), to_port(b))
    assert_same_counts(host_spgemm_counts(a, b), got)
    assert_counts(got, int_oracle(to_port(a), to_port(b)))
