"""The port's sparse union C = A OR B against the JAX package's, on the CPU:
``spm_or_padded`` over padded operands (packed and int64 keys), and
``spm_or`` on its host and device routes, bit-exact against the JAX package
and scipy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import host as jx_host
from binary_spgemm_tpu.ops import union as jx_union

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import host as tp_host
from binary_spgemm_tpu_torch.ops import union as tp_union
from binary_spgemm_tpu_torch.utils.oracle import union_oracle


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def assert_same(j, t):
    assert np.array_equal(j.indptr, t.indptr)
    assert np.array_equal(j.indices, t.indices)


def padded(mat, extra, fill_seed):
    """``(indptr, indices padded with garbage columns, nnz)``."""
    rng = np.random.default_rng(fill_seed)
    idx = rng.integers(0, mat.n_cols, mat.nnz + extra).astype(np.int32)
    idx[: mat.nnz] = mat.indices
    return mat.indptr.astype(np.int32), idx, mat.nnz


# packed int32 keys, and wide columns (int64 keys); 37 rows take the
# histogram, 3 the searchsorted
@pytest.mark.parametrize("n,m", [(37, 60), (3, 60), (37, 1 << 28), (3, 1 << 28)])
def test_spm_or_padded_matches_jax(n, m):
    a = jx.BCSR.random(n, m, 6.0, seed=n)
    b = jx.BCSR.random(n, m, 4.0, seed=n + 1)
    pa, pb = padded(a, 5, 1), padded(b, 11, 2)
    j = jx_union.spm_or_padded(
        *[jnp.asarray(x) for x in pa[:2]], jnp.int32(pa[2]),
        *[jnp.asarray(x) for x in pb[:2]], jnp.int32(pb[2]), n_cols=m)
    t = tp_union.spm_or_padded(
        *[torch.from_numpy(x) for x in pa[:2]], pa[2],
        *[torch.from_numpy(x) for x in pb[:2]], pb[2], n_cols=m)
    nnz = int(j[2])
    assert int(t[2]) == nnz and t[1].shape == (len(pa[1]) + len(pb[1]),)
    assert np.array_equal(np.asarray(j[0]), t[0].numpy())
    assert np.array_equal(np.asarray(j[1])[:nnz], t[1].numpy()[:nnz])
    c = tp.BCSR(t[0].numpy(), t[1].numpy()[:nnz], (n, m))
    assert c.equals(union_oracle(to_port(a), to_port(b)))


@pytest.mark.parametrize("route,n,d", [("host", 3000, 4.0), ("device", 40000, 8.0)])
def test_spm_or_routes(monkeypatch, route, n, d):
    ja, jb = jx.BCSR.random(n, n, d, seed=5), jx.BCSR.random(n, n, d, seed=6)
    ta, tb = to_port(ja), to_port(jb)
    assert (ta.nnz + tb.nnz <= tp_host.HOST_OR_MAX_NNZ) == (route == "host")
    served = []
    real = tp_host.host_spm_or
    monkeypatch.setattr(tp_host, "host_spm_or", lambda a, b: served.append(1) or real(a, b))
    c = tp.spm_or(ta, tb, device="cpu")
    assert bool(served) == (route == "host")
    assert_same(jx.spm_or(ja, jb), c)
    assert c.equals(union_oracle(ta, tb))


def test_spm_or_small_cases():
    """The JAX package's cases: hand-checked, idempotent, an empty operand,
    duplicates in an operand, a shape mismatch."""
    a = tp.BCSR.from_dense(np.array([[1, 0, 1], [0, 0, 0], [1, 1, 0]]))
    b = tp.BCSR.from_dense(np.array([[0, 1, 1], [1, 0, 0], [0, 0, 0]]))
    c = tp.spm_or(a, b, device="cpu")
    assert np.array_equal(c.to_dense(), a.to_dense() | b.to_dense())
    r = tp.BCSR.random(500, 700, 3.0, seed=2)
    assert tp.spm_or(r, r, device="cpu").equals(r.sum_duplicates())
    empty = tp.BCSR(np.zeros(501, np.int32), np.zeros(0, np.int32), (500, 700))
    assert tp.spm_or(r, empty, device="cpu").equals(r.sum_duplicates())
    rows, cols = r.to_coo()
    dup = tp.BCSR.from_coo(np.concatenate([rows, rows]), np.concatenate([cols, cols]),
                           r.shape)
    assert tp.spm_or(dup, empty, device="cpu").equals(r.sum_duplicates())
    with pytest.raises(ValueError, match="shape mismatch"):
        tp.spm_or(r, tp.BCSR.random(500, 699, 1.0, seed=1), device="cpu")


def test_host_spm_or_matches_jax():
    ja, jb = jx.BCSR.random(900, 400, 3.0, seed=8), jx.BCSR.random(900, 400, 5.0, seed=9)
    assert tp_host.HOST_OR_MAX_NNZ == jx_host.HOST_OR_MAX_NNZ
    assert_same(jx_host.host_spm_or(ja, jb), tp.host_spm_or(to_port(ja), to_port(jb)))
