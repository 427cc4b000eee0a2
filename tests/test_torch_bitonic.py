"""The port's row-sort wrappers (K1, K2) on the CPU: their plain versions
against the JAX package's Pallas kernels in interpret mode and its
``sort_rows`` fallback, and the wrappers' contract (no launch and no count on
a CPU tensor, raise on what the kernels do not take)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_spgemm_tpu.ops import bitonic as jx_bitonic

from binary_spgemm_tpu_torch.ops import bitonic

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min


def stream(k, L, seed, hi=50):
    rng = np.random.default_rng(seed)
    # duplicates and the int32 extremes the engine uses as sentinels
    x = rng.integers(0, hi, (k, L)).astype(np.int32)
    x[0, :3] = I32_MAX
    x[1, :2] = I32_MIN
    return x


@pytest.mark.parametrize("k,L", [(16, 256), (8, 1024), (24, 512)])
def test_k1_plain_matches_pallas_interpret(k, L):
    x = stream(k, L, k * L)
    want = np.asarray(jx_bitonic.bitonic_sort_rows(jnp.asarray(x), interpret=True))
    xt = torch.from_numpy(x)
    assert np.array_equal(bitonic.bitonic_sort_rows_plain(xt).numpy(), want)
    assert np.array_equal(bitonic.bitonic_sort_rows(xt).numpy(), want)


@pytest.mark.parametrize("k,L", [(6, 320), (4, 3968), (3, 1), (5, 37)])
def test_k1_matches_jax_sort_rows_at_any_length(k, L):
    rng = np.random.default_rng(3)
    x = rng.integers(I32_MIN, I32_MAX, (k, L), dtype=np.int64).astype(np.int32)
    want = np.asarray(jx_bitonic.sort_rows(jnp.asarray(x)))
    assert np.array_equal(bitonic.sort_rows(torch.from_numpy(x)).numpy(), want)


def test_k2_plain_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    k, L, limit = 16, 512, 400
    # duplicates + values at/above the limit (the demote band)
    x = rng.integers(0, 500, (k, L)).astype(np.int32)
    want = np.asarray(
        jx_bitonic.fused_sort_compress(jnp.asarray(x), limit, interpret=True)
    )
    xt = torch.from_numpy(x)
    assert np.array_equal(bitonic.fused_sort_compress_plain(xt, limit).numpy(), want)
    got = bitonic.fused_sort_compress(xt, limit)
    assert np.array_equal(got.numpy(), want)
    nnz = (got < limit).sum(dim=1).numpy()
    assert all(nnz[r] == len(np.unique(x[r][x[r] < limit])) for r in range(k))


def test_k2_equals_k1_twice_plus_dedup():
    x = torch.from_numpy(stream(12, 700, 5, hi=300))
    limit = 200
    s = bitonic.bitonic_sort_rows(x)
    prev = torch.cat([torch.full_like(s[:, :1], -1), s[:, :-1]], dim=1)
    keep = (s != prev) & (s < limit)
    want = bitonic.bitonic_sort_rows(torch.where(keep, s, int(I32_MAX)))
    assert torch.equal(bitonic.fused_sort_compress(x, limit), want)


def test_cpu_tensors_launch_nothing():
    bitonic.bitonic_sort_rows.launches = 0
    bitonic.fused_sort_compress.launches = 0
    x = torch.from_numpy(stream(4, 64, 1))
    bitonic.bitonic_sort_rows(x)
    bitonic.sort_rows(x)
    bitonic.fused_sort_compress(x, 10)
    assert bitonic.bitonic_sort_rows.launches == 0
    assert bitonic.fused_sort_compress.launches == 0


@pytest.mark.parametrize(
    "bad",
    [
        torch.zeros((4, 8), dtype=torch.int64),  # not int32
        torch.zeros(8, dtype=torch.int32),  # not 2-D
        torch.zeros((8, 4), dtype=torch.int32).t(),  # not contiguous
        torch.zeros((1, bitonic.MAX_L + 1), dtype=torch.int32),  # past smem
    ],
)
def test_wrappers_raise_on_what_the_kernels_do_not_take(bad):
    with pytest.raises(ValueError):
        bitonic.bitonic_sort_rows(bad)
    with pytest.raises(ValueError):
        bitonic.fused_sort_compress(bad, 3)


def test_k2_limit_must_be_int32():
    with pytest.raises(ValueError, match="int32"):
        bitonic.fused_sort_compress(torch.zeros((2, 4), dtype=torch.int32), 1 << 31)


def test_longest_row_is_one_power_of_two_of_shared_memory():
    assert bitonic.MAX_L == 1 << 15
    x = torch.from_numpy(stream(2, bitonic.MAX_L, 4, hi=1 << 20))
    assert torch.equal(bitonic.sort_rows(x), torch.sort(x, dim=1).values)
