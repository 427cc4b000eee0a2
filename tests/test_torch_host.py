"""The port's host engine (``ops/host.py``) against the JAX package's host
engine and scipy, on ``tests/test_host.py``'s cases, and its route in
``spgemm``: small-flop products take it, bigger ones and an explicit
``chunk_flops`` do not."""
import numpy as np
import pytest

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import host as jx_host

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import ell as tp_ell
from binary_spgemm_tpu_torch.ops import host
from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle

CASES = [
    (120, 90, 150, 3.0, 0),
    (64, 64, 64, 5.0, 1),
    (300, 40, 300, 2.0, 2),
    (1, 50, 1, 4.0, 3),
    (50, 50, 50, 0.0, 4),  # empty-ish
]


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def same(j, t):
    return np.array_equal(j.indptr, t.indptr) and np.array_equal(j.indices, t.indices)


@pytest.mark.parametrize("n,k,m,d,seed", CASES)
def test_host_spgemm_matches_jax_and_oracle(n, k, m, d, seed):
    ja = jx.BCSR.random(n, k, d, seed=seed)
    jb = jx.BCSR.random(k, m, d, seed=seed + 100)
    a, b = to_port(ja), to_port(jb)
    c = host.host_spgemm(a, b)
    assert same(jx_host.host_spgemm(ja, jb), c)
    assert c.equals(spgemm_oracle(a, b))
    assert tp.host_spgemm is host.host_spgemm


@pytest.mark.parametrize("n,k,m,d,seed", CASES[:3])
def test_expansion_and_keys_match_jax(n, k, m, d, seed):
    ja = jx.BCSR.random(n, k, d, seed=seed)
    jb = jx.BCSR.random(k, m, d, seed=seed + 100)
    a, b = to_port(ja), to_port(jb)
    rows, cols = host._expand_numpy(a, b)
    j_rows, j_cols = jx_host._expand_numpy(ja, jb)
    assert np.array_equal(rows, j_rows) and np.array_equal(cols, j_cols)
    keys = np.unique(rows * np.int64(m) + cols)
    assert same(jx_host._keys_to_csr(keys, n, m), host._keys_to_csr(keys, n, m))


def test_route_pinning(monkeypatch):
    """Small-flop inputs route to the host engine; an explicit chunk_flops
    (the chunked ESC engine) and big products do not."""
    calls = []
    real = host.host_spgemm
    monkeypatch.setattr(host, "host_spgemm", lambda a, b: calls.append(1) or real(a, b))
    small = tp.BCSR.random(500, 500, 2.0, seed=5)  # ~2K flops
    c = tp.spgemm(small, small, device="cpu")
    assert calls, "small input did not take the host route"
    assert c.equals(spgemm_oracle(small, small))
    calls.clear()
    c = tp.spgemm(small, small, chunk_flops=10_000, device="cpu")
    assert not calls
    assert c.equals(spgemm_oracle(small, small))
    ex = tp.SpGEMMExecutor(small, small, chunk_flops=10_000, device="cpu")
    assert c.equals(ex.assemble(ex.run()))
    big = tp.BCSR.random(3000, 3000, 30.0, seed=6)
    assert tp.spgemm_flops(big, big) > host.HOST_MAX_FLOPS
    tp_ell._EXEC_CACHE.clear()
    assert tp.spgemm(big, big, device="cpu").equals(spgemm_oracle(big, big))
    assert not calls


@pytest.mark.parametrize("seed", [42, 7])
def test_validity_class_routes_host(monkeypatch, seed):
    """The reference's own make-test class (n = 50000, about 25,000 nnz;
    seed 7 is the JAX package's ``validity-class`` config) is served by the
    host engine, bit-exact, whatever device is asked for."""
    calls = []
    real = host.host_spgemm
    monkeypatch.setattr(host, "host_spgemm", lambda a, b: calls.append(1) or real(a, b))
    ja = jx.BCSR.random(50_000, 50_000, 0.5, seed=seed)
    a = to_port(ja)
    assert tp.spgemm_flops(a, a) <= host.HOST_MAX_FLOPS
    c = tp.spgemm(a, a, device="cpu")
    assert calls == [1]
    assert same(jx.spgemm(ja, ja), c)
    assert c.equals(spgemm_oracle(a, a))


def test_threshold_is_the_jax_packages():
    assert host.HOST_MAX_FLOPS == jx_host.HOST_MAX_FLOPS == 2_000_000


def test_shape_mismatch_raises():
    a = tp.BCSR.random(10, 12, 2.0, seed=1)
    with pytest.raises(ValueError, match="shape mismatch"):
        host.host_spgemm(a, a)
