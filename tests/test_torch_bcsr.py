"""The port's BCSR container against the JAX package's: same arrays from the
same seed, the same COO grouping, and the same oracle."""
import numpy as np
import pytest

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.formats import bcsr as jx_bcsr
from binary_spgemm_tpu.utils.oracle import spgemm_oracle as jx_oracle

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.formats import bcsr as tp_bcsr
from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle as tp_oracle


def same(j, t):
    return (
        tuple(j.shape) == tuple(t.shape)
        and j.indptr.dtype == t.indptr.dtype
        and np.array_equal(j.indptr, t.indptr)
        and np.array_equal(j.indices, t.indices)
    )


@pytest.mark.parametrize(
    "n,m,d,seed",
    [
        (3000, 3000, 4.0, 1),
        (8000, 8000, 2.0, 2),
        (4000, 1500, 3.0, 6),
        (1, 1, 16.0, 5),
        (50, 70, 0.0, 9),  # no draws: the empty matrix
        (65536, 65536, 2.0, 31),
    ],
)
def test_random_matches_jax(n, m, d, seed):
    assert same(jx.BCSR.random(n, m, d, seed=seed), tp.BCSR.random(n, m, d, seed=seed))


def test_from_coo_keeps_input_order_and_duplicates():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 40, 500)
    cols = rng.integers(0, 60, 500)
    for transpose in (False, True):
        j = jx.BCSR.from_coo(rows, cols, (40, 60), transpose=transpose)
        t = tp.BCSR.from_coo(rows, cols, (40, 60), transpose=transpose)
        assert same(j, t)
    assert not tp.BCSR.from_coo(rows, cols, (40, 60)).is_canonical()
    with pytest.raises(ValueError, match="column index out of range"):
        tp.BCSR.from_coo(rows, cols, (40, 50))
    with pytest.raises(ValueError, match="row index out of range"):
        tp.BCSR.from_coo(rows, cols, (30, 60))


def test_bcsr_from_arrays_copies_a_jax_matrix():
    j = jx.BCSR.random(500, 400, 3.0, seed=3)
    t = tp.bcsr_from_arrays(j.indptr, j.indices, j.shape)
    assert same(j, t) and t.is_canonical()
    t.indices[0] += 1  # a copy: the JAX matrix is untouched
    assert not np.array_equal(j.indices, t.indices)
    assert t.equals(tp.BCSR.random(500, 400, 3.0, seed=3)) is False


def test_indptr_promotes_to_int64(monkeypatch):
    monkeypatch.setattr(jx_bcsr, "INDPTR_INT32_MAX", 10)
    monkeypatch.setattr(tp_bcsr, "INDPTR_INT32_MAX", 10)
    j = jx.BCSR.random(20, 20, 2.0, seed=4)
    t = tp.BCSR.random(20, 20, 2.0, seed=4)
    assert t.indptr.dtype == np.int64 and same(j, t)
    small = tp.BCSR(np.array([0, 1, 2]), np.array([0, 1]), (2, 2))
    assert small.indptr.dtype == np.int32 and small.nnz == 2
    with pytest.raises(ValueError, match="indptr"):
        tp.BCSR(np.array([0, 1]), np.array([0, 1]), (1, 2))


def test_scipy_round_trip_and_oracle():
    j = jx.BCSR.random(700, 700, 5.0, seed=11)
    t = tp.BCSR.random(700, 700, 5.0, seed=11)
    assert tp.BCSR.from_scipy(t.to_scipy()).equals(t)
    assert same(jx_oracle(j, j), tp_oracle(t, t))
    assert tp_oracle(t, t).is_canonical()
    assert (t.n_rows, t.n_cols, t.nnz) == (700, 700, j.nnz)


def test_row_transpose_sort_indices_flops_match_jax():
    j = jx.BCSR.random(300, 200, 4.0, seed=8)
    jb = jx.BCSR.random(200, 250, 3.0, seed=9)
    t, tb = tp.BCSR.random(300, 200, 4.0, seed=8), tp.BCSR.random(200, 250, 3.0, seed=9)
    for i in (0, 17, 299):
        assert np.array_equal(j.row(i), t.row(i))
    assert same(j.transpose(), t.transpose())
    assert t.transpose().transpose().equals(t)
    assert t.flops(tb) == j.flops(jb) == tp.spgemm_flops(t, tb)
    # a shuffled, duplicated COO: sort_indices orders each row, keeps duplicates
    rng = np.random.default_rng(2)
    rows, cols = rng.integers(0, 40, 400), rng.integers(0, 30, 400)
    js = jx.BCSR.from_coo(rows, cols, (40, 30)).sort_indices()
    ts = tp.BCSR.from_coo(rows, cols, (40, 30)).sort_indices()
    assert same(js, ts) and ts.nnz == 400 and not ts.is_canonical()
    assert ts.sum_duplicates().is_canonical()


def test_diff_matches_jax():
    t = tp.BCSR.random(120, 120, 3.0, seed=4)
    j = jx.BCSR(t.indptr, t.indices, t.shape)
    assert t.diff(t) == "" == j.diff(j)
    rows, cols = t.to_coo()
    cols2 = cols.copy()
    cols2[5] = (cols2[5] + 1) % 120  # one column moved: same row lengths
    keep = np.ones(len(rows), bool)
    keep[-1] = False  # one entry dropped: a row length differs
    for r, c in ((rows, cols2), (rows[keep], cols[keep])):
        u = tp.BCSR.from_coo(r, c, t.shape)
        ju = jx.BCSR(u.indptr, u.indices, u.shape)
        assert t.diff(u) == j.diff(ju) != ""
        assert t.diff(u, max_rows=1) == j.diff(ju, max_rows=1)
    other = tp.BCSR.random(120, 121, 3.0, seed=4)
    assert t.diff(other) == j.diff(jx.BCSR(other.indptr, other.indices, other.shape))
    assert t.diff(other).startswith("shape mismatch")


def test_torch_round_trip_matches_jax():
    import torch

    t = tp.BCSR.random(90, 70, 3.0, seed=5)
    j = jx.BCSR(t.indptr, t.indices, t.shape)
    st, sj = t.to_torch(), j.to_torch()
    assert st.layout == torch.sparse_csr and st.device.type == "cpu"
    assert st.values().dtype == torch.bool and tuple(st.shape) == (90, 70)
    for x, y in ((st.crow_indices(), sj.crow_indices()), (st.col_indices(), sj.col_indices())):
        assert torch.equal(x, y)
    vals = torch.ones(t.nnz, dtype=torch.float32)
    vals[::4] = 0  # explicit zeros, dropped by from_torch
    csr = torch.sparse_csr_tensor(st.crow_indices(), st.col_indices(), vals, size=(90, 70))
    dense = csr.to_dense()
    for x in (st, csr, csr.to_sparse_coo(), csr.to_sparse_csc(), dense, dense.to_sparse()):
        assert same(jx.BCSR.from_torch(x), tp.BCSR.from_torch(x))
    assert tp.BCSR.from_torch(st).equals(t)
    assert tp.BCSR.from_torch(csr).nnz == t.nnz - len(vals[::4])
