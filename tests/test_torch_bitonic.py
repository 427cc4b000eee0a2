"""The port's row-sort wrappers (K1, K2) on the CPU: their plain versions
against the JAX package's Pallas kernels in interpret mode and its
``sort_rows`` fallback, the wrappers' contract (no launch and no count on
a CPU tensor, raise on what the kernels do not take), K1's choice of kernel,
and a numpy model of K1's register kernel (``csrc/bitonic.cu``,
``sort_rows_reg_kernel``) that runs its schedule step by step."""
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


@pytest.mark.parametrize("k,L", [(16, 256), (8, 1024), (24, 512), (8, 2048), (8, 4096)])
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


@pytest.mark.parametrize("k,L", [(2, 40000), (3, bitonic.MAX_L + 1), (1, 70000)])
def test_sort_rows_past_the_kernels_window(k, L):
    """Rows longer than MAX_L take torch.sort, as the JAX package's
    sort_rows takes lax.sort outside its kernel's window; K1 itself still
    raises there."""
    rng = np.random.default_rng(L)
    x = rng.integers(I32_MIN, I32_MAX, (k, L), dtype=np.int64, endpoint=True)
    x = x.astype(np.int32)
    x[0, :5] = x[0, 7]  # duplicates
    xt = torch.from_numpy(x)
    before = dict(bitonic.sort_rows.routes)
    got = bitonic.sort_rows(xt)
    assert bitonic.sort_rows.routes == {"k1": before["k1"],
                                        "torch_sort": before["torch_sort"] + 1}
    assert torch.equal(got, torch.sort(xt, dim=1).values)
    assert np.array_equal(got.numpy(), np.asarray(jx_bitonic.sort_rows(jnp.asarray(x))))
    with pytest.raises(ValueError, match="shared-memory"):
        bitonic.bitonic_sort_rows(xt)


@pytest.mark.parametrize("L,route", [(1, "k1"), (4096, "k1"), (bitonic.MAX_L, "k1"),
                                     (bitonic.MAX_L + 1, "torch_sort")])
def test_sort_rows_route_is_a_function_of_the_row_length(L, route):
    x = torch.from_numpy(stream(2, L, 6, hi=1 << 20)) if L >= 3 else torch.zeros(
        (2, L), dtype=torch.int32)
    before = dict(bitonic.sort_rows.routes)
    assert torch.equal(bitonic.sort_rows(x), torch.sort(x, dim=1).values)
    after = bitonic.sort_rows.routes
    assert after[route] == before[route] + 1
    assert sum(after.values()) == sum(before.values()) + 1


@pytest.mark.parametrize(
    "L,variant",
    [(1, "smem"), (2, "smem"), (128, "smem"), (129, "reg"), (255, "reg"),
     (256, "reg"), (257, "reg"), (3968, "reg"), (4095, "reg"), (4096, "reg"),
     (4097, "smem"), (32768, "smem")],
)
def test_k1_variant_is_a_function_of_the_row_length(L, variant):
    assert bitonic.k1_variant(L) == variant


def test_k1_variants_on_the_cpu_are_the_plain_version():
    bitonic.bitonic_sort_rows.launches = 0
    x = torch.from_numpy(stream(5, 300, 2))
    for variant in ("reg", "smem"):
        assert torch.equal(bitonic._sort_rows_variant(x, variant),
                           torch.sort(x, dim=1).values)
    assert bitonic.bitonic_sort_rows.launches == 0
    with pytest.raises(ValueError, match="'reg' takes rows"):
        bitonic._sort_rows_variant(torch.from_numpy(stream(4, 128, 2)), "reg")
    with pytest.raises(ValueError, match="unknown K1 variant"):
        bitonic._sort_rows_variant(x, "cub")


# --- numpy model of sort_rows_reg_kernel -------------------------------------
# The same block shape, slot <-> thread mapping, load/store, 16-byte word order
# and step placement as the CUDA source: one block of THREADS threads holds
# SLOTS = THREADS * PER_THREAD slots, thread t the slots 8t ... 8t + 7.

THREADS, PER_THREAD = 512, 8
SLOTS = THREADS * PER_THREAD


def _to_shared(r):
    """Registers [nb, THREADS, 8] -> shared [nb, SLOTS] as to_shared writes
    them: thread t's two 16-byte words, word h = (t >> 2) & 1 first."""
    t = np.arange(THREADS)
    h = (t >> 2) & 1
    odd = (h == 1)[None, :, None]
    lo, hi = r[:, :, :4], r[:, :, 4:]
    w = np.empty((r.shape[0], THREADS, 2, 4), r.dtype)
    w[:, t, h] = np.where(odd, hi, lo)  # w[h] = h ? hi : lo
    w[:, t, h ^ 1] = np.where(odd, lo, hi)  # w[h ^ 1] = h ? lo : hi
    return w.reshape(r.shape[0], SLOTS)


def _from_shared(s):
    t = np.arange(THREADS)
    h = (t >> 2) & 1
    odd = (h == 1)[None, :, None]
    w = s.reshape(s.shape[0], THREADS, 2, 4)
    a, b = w[:, t, h], w[:, t, h ^ 1]
    return np.concatenate([np.where(odd, b, a), np.where(odd, a, b)], axis=2)


def reg_kernel_model(x):
    """Run sort_rows_reg_kernel's schedule on int32 ``[k, L]`` ``x``; return
    the sorted rows and the number of steps run in each place."""
    k, L = x.shape
    log_p = (L - 1).bit_length()
    assert 8 <= log_p <= 12
    P = 1 << log_p
    nb = -(-k // (SLOTS >> log_p))
    t = np.arange(THREADS)
    e = np.arange(SLOTS)
    # load_rows: slot e of block b is row b * (SLOTS / P) + (e >> log_p), column e & (P - 1)
    row = (np.arange(nb) * (SLOTS >> log_p))[:, None] + (e >> log_p)[None]
    col = np.broadcast_to(e & (P - 1), row.shape)
    ok = (col < L) & (row < k)
    s = np.full((nb, SLOTS), I32_MAX, np.int32)
    s[ok] = x[row[ok], col[ok]]
    r = _from_shared(s)
    steps = {"register": 0, "shuffle": 0, "shared": 0, "shared phases": 0}

    def ascending(i, lk):
        return np.ones(np.shape(i), bool) if lk == log_p else (i & (1 << lk)) == 0

    for lk in range(1, log_p + 1):
        if lk - 1 >= 8:
            s = _to_shared(r)
            steps["shared phases"] += 1
            for lj in range(lk - 1, 7, -1):
                j = 1 << lj
                p = (np.arange(SLOTS // 2 // THREADS)[:, None] * THREADS + t).ravel()
                i = 2 * p - (p & (j - 1))
                a, b = s[:, i], s[:, i + j]
                up = ascending(i, lk)[None]
                s[:, i] = np.where(up, np.minimum(a, b), np.maximum(a, b))
                s[:, i + j] = np.where(up, np.maximum(a, b), np.minimum(a, b))
                steps["shared"] += 1
            r = _from_shared(s)
        for lj in range(min(lk - 1, 7), -1, -1):
            if lj >= 3:
                m = 1 << (lj - 3)
                partner = (t & ~31) | ((t & 31) ^ m)  # __shfl_xor_sync(..., m)
                o = r[:, partner]
                lower = (t & m) == 0
                keep_min = (lower == ascending(t * PER_THREAD, lk))[None, :, None]
                r = np.where(keep_min, np.minimum(r, o), np.maximum(r, o))
                steps["shuffle"] += 1
            else:
                j = 1 << lj
                for q in range(PER_THREAD):
                    if q & j:
                        continue
                    a, b = r[:, :, q].copy(), r[:, :, q | j].copy()
                    up = ascending(t * PER_THREAD + q, lk)[None]
                    r[:, :, q] = np.where(up, np.minimum(a, b), np.maximum(a, b))
                    r[:, :, q | j] = np.where(up, np.maximum(a, b), np.minimum(a, b))
                steps["register"] += 1
    s = _to_shared(r)
    out = np.empty_like(x)
    out[row[ok], col[ok]] = s[ok]  # store_rows: the first L slots of each row
    return out, steps


def test_model_word_order_round_trips():
    r = np.arange(2 * SLOTS, dtype=np.int32).reshape(2, THREADS, PER_THREAD)
    assert np.array_equal(_to_shared(r).reshape(r.shape), r)
    assert np.array_equal(_from_shared(_to_shared(r)), r)


@pytest.mark.parametrize(
    "k,L",
    [(40, 256), (9, 129), (33, 200), (12, 512), (7, 1024), (5, 700),
     (3, 2048), (3, 1500), (2, 4096), (3, 3968), (2, 4095)],
)
def test_reg_kernel_model_sorts_like_np_sort(k, L):
    rng = np.random.default_rng(k * L)
    x = rng.integers(I32_MIN, I32_MAX, (k, L), dtype=np.int64, endpoint=True)
    x = x.astype(np.int32)
    x[0, :3] = I32_MAX
    x[-1, :2] = I32_MIN
    x[k // 2, : L // 2] = x[k // 2, 0]  # duplicates
    got, _ = reg_kernel_model(x)
    assert np.array_equal(got, np.sort(x, axis=1))


@pytest.mark.parametrize("log_p", [8, 9, 10, 11, 12])
def test_reg_kernel_model_step_placement(log_p):
    x = stream(2, 1 << log_p, log_p)
    got, steps = reg_kernel_model(x)
    assert np.array_equal(got, np.sort(x, axis=1))
    lanes = sum(min(lk, 8) for lk in range(1, log_p + 1))
    assert steps["register"] + steps["shuffle"] == lanes
    assert steps["register"] == sum(min(lk, 3) for lk in range(1, log_p + 1))
    assert steps["shared phases"] == max(0, log_p - 8)
    assert sum(v for n, v in steps.items() if n != "shared phases") == (
        log_p * (log_p + 1) // 2
    )
    if log_p == 12:  # the main path's padded length
        assert (steps["register"], steps["shuffle"], steps["shared"],
                steps["shared phases"]) == (33, 35, 10, 4)
