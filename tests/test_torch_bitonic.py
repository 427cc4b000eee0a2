"""The port's row-sort wrappers (K1, K2) on the CPU: their plain versions
against the JAX package's Pallas kernels in interpret mode and its
``sort_rows`` fallback, the wrappers' contract (no launch and no count on
a CPU tensor, raise on what the kernels do not take), K1's choice of kernel,
numpy models of K1's warp, register and wide kernels (``csrc/bitonic.cu``,
``sort_rows_warp_kernel``, ``sort_rows_reg_kernel`` and
``sort_rows_wide_kernel``) that run their schedules step by step, and a
numpy model of K2's compaction epilogue on each of their thread layouts."""
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
    [(1, "warp"), (2, "warp"), (128, "warp"), (129, "reg"), (255, "reg"),
     (256, "reg"), (257, "reg"), (3968, "reg"), (4095, "reg"), (4096, "reg"),
     (4097, "wide"), (32768, "wide"), (4352, "wide"), (8192, "wide"), (8193, "wide"),
     (16384, "wide"), (16385, "wide"), (32767, "wide"), (32769, "smem")],
)
def test_k1_variant_is_a_function_of_the_row_length(L, variant):
    assert bitonic.k1_variant(L) == variant


def test_k1_variants_on_the_cpu_are_the_plain_version():
    bitonic.bitonic_sort_rows.launches = 0
    by_variant = dict(bitonic.bitonic_sort_rows.launches_by_variant)
    x = torch.from_numpy(stream(5, 300, 2))
    xw = torch.from_numpy(stream(3, 5000, 2, hi=1 << 20))
    xs_ = torch.from_numpy(stream(7, 100, 2))
    for variant, xs in (("reg", x), ("smem", x), ("wide", xw), ("smem", xw),
                        ("warp", xs_), ("smem", xs_)):
        assert torch.equal(bitonic._sort_rows_variant(xs, variant),
                           torch.sort(xs, dim=1).values)
    assert bitonic.bitonic_sort_rows.launches == 0
    assert bitonic.bitonic_sort_rows.launches_by_variant == by_variant
    assert set(by_variant) == {"warp", "reg", "wide", "smem"}
    with pytest.raises(ValueError, match="'reg' takes rows"):
        bitonic._sort_rows_variant(torch.from_numpy(stream(4, 128, 2)), "reg")
    with pytest.raises(ValueError, match="'warp' takes rows"):
        bitonic._sort_rows_variant(x, "warp")
    with pytest.raises(ValueError, match="'wide' takes rows"):
        bitonic._sort_rows_variant(torch.from_numpy(stream(4, 4096, 2)), "wide")
    with pytest.raises(ValueError, match="'reg' takes rows"):
        bitonic._sort_rows_variant(xw, "reg")
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


# --- numpy model of sort_rows_wide_kernel ------------------------------------
# One block a row: T = P / N threads, thread t holding the N contiguous slots
# N t ... N t + N - 1 (bitonic.wide_block gives T and N, and the wrappers pass
# them to the source's launch_wide).  Steps run inside the thread (partner bit below log2 N), by
# shuffle (the 5 lane bits above) or in shared memory (the warp bits), slot i at
# shared word wide_swz(i).  sort=True is K1's all-ascending form with the
# padding skip; sort=False the alternating form from merge 2^lk0 (P1/P2).

# steps by place for each block shape (P, T, N), as the note at the top of
# csrc/bitonic.cu states them: (register, shuffle, shared, shared phases), and
# a row length and form that takes the shape
WIDE_STEPS = {(8192, 512, 16): ((46, 35, 10, 4), 4600, True),
              (8192, 256, 32): ((55, 30, 6, 3), 8190, True),
              (16384, 512, 32): ((60, 35, 10, 4), 16380, True),
              (16384, 1024, 16): ((50, 40, 15, 5), 16384, False),
              (32768, 1024, 32): ((65, 40, 15, 5), 32760, True),
              (32768, 512, 64): ((75, 35, 10, 4), 32768, False)}


def wide_swz(i, log_n):
    return i ^ (((i >> max(5, log_n)) & 7) << 2)


def _reference_step(v, P, lk, lj, sort):
    """One step of the whole network over padded rows ``v`` [k, P]: every
    pair, no skip."""
    i = np.arange(P)
    i = i[(i & (1 << lj)) == 0]
    u = i ^ ((1 << lk) - 1) if sort and lj == lk - 1 else i + (1 << lj)
    a, b = v[:, i], v[:, u]
    up = np.ones(i.shape, bool) if sort or lk == P.bit_length() - 1 else (i & (1 << lk)) == 0
    v[:, i] = np.where(up, np.minimum(a, b), np.maximum(a, b))
    v[:, u] = np.where(up, np.maximum(a, b), np.minimum(a, b))


def wide_kernel_model(x, sort=True, lk0=1):
    """Run sort_rows_wide_kernel's schedule on int32 ``[k, L]`` ``x``, one
    block a row, holding every step against the whole network on the padded
    rows.  Returns the output, the steps run in each place, and what the
    padding saw."""
    k, L = x.shape
    log_p = (L - 1).bit_length()
    assert 13 <= log_p <= 15 and (sort or L == 1 << log_p)
    T, N = bitonic.wide_block(L, sort)
    log_n = N.bit_length() - 1
    P = 1 << log_p
    assert T * N == P
    lane = log_n + 5
    t = np.arange(T)
    tl = t[:, None]
    slot = (tl << log_n) + np.arange(N)[None]  # [T, N]: thread t's slots
    active = ((t & ~31) << log_n) < L if sort else np.ones(T, bool)
    word = lambda c: wide_swz((tl << log_n) + 4 * c, log_n) + np.arange(4)[None]
    sm = np.zeros((k, P), np.int32)
    written = np.zeros(P, bool)  # shared words written so far
    seen = {"device_columns": [], "shared_slots": [], "skipped_warp_steps": 0,
            "steps": {"register": 0, "shuffle": 0, "shared": 0, "shared phases": 0}}

    # load: columns below L only, coalesced, into their swizzled words
    c = np.arange(L)
    seen["device_columns"].append(c)
    sm[:, wide_swz(c, log_n)] = x
    written[wide_swz(c, log_n)] = True
    r = np.full((k, T, N), I32_MAX, np.int32)

    def from_shared(first=False):
        for cw in range(N // 4):
            w = word(cw)[active]
            assert first or written[w].all()
            r[:, active, 4 * cw : 4 * cw + 4] = sm[:, w]
        if first:  # a slot past L is never read: INT32_MAX in its register
            r[:, slot >= L] = I32_MAX

    def to_shared():
        for cw in range(N // 4):
            w = word(cw)[active]
            sm[:, w] = r[:, active, 4 * cw : 4 * cw + 4]
            written[w] = True

    from_shared(first=True)
    ref = np.full((k, P), I32_MAX, np.int32)
    ref[:, :L] = x

    def held(place):
        """The kernel's rows as the step left them, against the whole network."""
        if place == "shared":
            got = np.full((k, P), I32_MAX, np.int32)
            got[:, :L] = sm[:, wide_swz(np.arange(L), log_n)]
        else:
            got = np.empty((k, P), np.int32)
            got[:, slot.ravel()] = r.reshape(k, -1)
        assert np.array_equal(got, ref), place
        assert (got[:, L:] == I32_MAX).all()

    def ascending(i, lk):
        return np.ones(np.shape(i), bool) if sort or lk == log_p else (i & (1 << lk)) == 0

    for lk in range(lk0, log_p + 1):
        if lk - 1 >= lane:
            to_shared()
            seen["steps"]["shared phases"] += 1
            for lj in range(lk - 1, lane - 1, -1):
                j, mirror = 1 << lj, sort and lj == lk - 1
                p = (np.arange(N // 2)[:, None] * T + t[None]).ravel()
                i = 2 * p - (p & (j - 1))
                u = i ^ ((1 << lk) - 1) if mirror else i + j
                go = u < L if sort else np.ones(i.shape, bool)
                i, u = i[go], u[go]
                wi, wu = wide_swz(i, log_n), wide_swz(u, log_n)
                assert written[wi].all() and written[wu].all()
                seen["shared_slots"] += [i, u]
                a, b = sm[:, wi], sm[:, wu]
                up = ascending(i, lk)
                sm[:, wi] = np.where(up, np.minimum(a, b), np.maximum(a, b))
                sm[:, wu] = np.where(up, np.maximum(a, b), np.minimum(a, b))
                seen["steps"]["shared"] += 1
                _reference_step(ref, P, lk, lj, sort)
                held("shared")
            from_shared()
        for lj in range(min(lk - 1, lane - 1), -1, -1):
            mirror = sort and lj == lk - 1
            new = r.copy()
            if lj >= log_n:
                m = (1 << (lk - log_n)) - 1 if mirror else 1 << (lj - log_n)
                partner = (t & ~31) | ((t & 31) ^ m)  # __shfl_xor_sync(..., m)
                o = r[:, partner, ::-1] if mirror else r[:, partner]
                lower = (t & (1 << (lj - log_n))) == 0
                keep_min = lower == ascending(t << log_n, lk)
                new = np.where(keep_min[None, :, None], np.minimum(r, o), np.maximum(r, o))
                seen["steps"]["shuffle"] += 1
            else:
                j = 1 << lj
                for e in range(N):
                    if e & j:
                        continue
                    f = e ^ ((1 << lk) - 1) if mirror else e | j
                    a, b = r[:, :, e], r[:, :, f]
                    up = ascending(slot[:, e], lk)[None]
                    new[:, :, e] = np.where(up, np.minimum(a, b), np.maximum(a, b))
                    new[:, :, f] = np.where(up, np.maximum(a, b), np.minimum(a, b))
                seen["steps"]["register"] += 1
            r[:, active] = new[:, active]  # an idle warp skips the step
            seen["skipped_warp_steps"] += int((~active[::32]).sum())
            _reference_step(ref, P, lk, lj, sort)
            held("registers")
    to_shared()
    # store: columns below L only
    out = np.empty_like(x)
    out[:] = sm[:, wide_swz(np.arange(L), log_n)]
    seen["device_columns"].append(np.arange(L))
    return out, seen


WIDE_LENGTHS = [4097, 4352, 4608, 4864, 6912, 7232, 7552, 8096, 8192, 8193, 16384,
                16385, 17408, 32768]


@pytest.mark.parametrize("L", WIDE_LENGTHS)
def test_wide_kernel_model_sorts_like_np_sort_and_jax(L):
    rng = np.random.default_rng(L)
    k = 3
    x = rng.integers(I32_MIN, I32_MAX, (k, L), dtype=np.int64, endpoint=True)
    x = x.astype(np.int32)
    x[0, :3] = I32_MAX
    x[0, -2:] = I32_MIN
    x[1] = x[1, 0]  # a row of a single value
    x[2, : L // 2] = x[2, 7]  # duplicates
    assert bitonic.k1_variant(L) == "wide"
    got, seen = wide_kernel_model(x)
    want = np.sort(x, axis=1)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jx_bitonic.sort_rows(jnp.asarray(x))))
    assert np.array_equal(bitonic.sort_rows(torch.from_numpy(x)).numpy(), want)
    # the padding: never loaded or stored, never touched by a shared step (and
    # INT32_MAX in every step, which wide_kernel_model holds)
    assert all(c.max() < L for c in seen["device_columns"])
    if seen["shared_slots"]:
        assert max(int(s.max()) for s in seen["shared_slots"]) < L
    P = 1 << (L - 1).bit_length()
    warps_idle = (P - L) // (32 * bitonic.wide_block(L)[1])
    lane_steps = seen["steps"]["register"] + seen["steps"]["shuffle"]
    assert seen["skipped_warp_steps"] == warps_idle * lane_steps


@pytest.mark.parametrize("shape", sorted(WIDE_STEPS))
def test_wide_kernel_model_step_placement(shape):
    steps, L, sort = WIDE_STEPS[shape]
    assert (1 << (L - 1).bit_length(), *bitonic.wide_block(L, sort)) == shape
    _, seen = wide_kernel_model(stream(2, L, L, hi=1 << 20), sort=sort)
    st = seen["steps"]
    assert (st["register"], st["shuffle"], st["shared"], st["shared phases"]) == steps
    log_p, log_n = (L - 1).bit_length(), shape[2].bit_length() - 1
    assert st["register"] == sum(min(lk, log_n) for lk in range(1, log_p + 1))
    assert st["shuffle"] == sum(min(max(lk - log_n, 0), 5) for lk in range(1, log_p + 1))
    assert st["shared phases"] == log_p - log_n - 5
    assert st["register"] + st["shuffle"] + st["shared"] == log_p * (log_p + 1) // 2


def _wide_source():
    from pathlib import Path

    return (Path(bitonic.__file__).parents[1] / "csrc" / "bitonic.cu").read_text()


def _wide_shapes_built():
    """(log2 P, log2 N, sort) of every block shape the source's launch_wide
    switches to: the shapes built, of which the wrappers pick by
    bitonic.wide_block."""
    import re

    src = _wide_source()
    body = src[src.index("cudaError_t launch_wide(const void*"):]
    body = body[: body.index("\n}\n")]
    return {(int(lp), int(ln), form == "true") for lp, ln, form in
            re.findall(r"launch_wide_shape<(\d+), (\d+), (true|false)>", body)}


def test_wide_kernel_model_steps_match_the_source_note():
    from binary_spgemm_tpu_torch.benchmarks.k1_wide_shapes import LOG_N

    note = " ".join(_wide_source().replace("//", " ").split())
    for (P, T, N), ((reg, shfl, shared, phases), _, _) in WIDE_STEPS.items():
        line = (f"P = {P}: {T} x {N}, {reg} register, {shfl} shuffle, {shared} "
                f"shared-memory steps in {phases} phases")
        assert line in note, line
    built = _wide_shapes_built()
    assert {(1 << lp, 1 << (lp - ln), 1 << ln) for lp, ln, _ in built} == set(WIDE_STEPS)
    # the shapes driver times every K1 shape built
    assert {(lp, ln) for lp, ln, sort in built if sort} == {
        (lp, ln) for lp, lns in LOG_N.items() for ln in lns}


@pytest.mark.parametrize("L", [4097, 4352, 4608, 4609, 4864, 6912, 7232, 8096, 8192, 8193,
                               16384, 16385, 17408, 32767, 32768])
def test_wide_block_picks_a_shape_the_source_builds(L):
    """The card runs the shape wide_block picks (the model's schedule), and
    launch_wide refuses any shape it does not build."""
    built = _wide_shapes_built()
    forms = (True, False) if L & (L - 1) == 0 else (True,)
    for sort in forms:
        T, N = bitonic.wide_block(L, sort)
        log_p = (L - 1).bit_length()
        assert T * N == 1 << log_p and T % 32 == 0 and T <= 1024
        assert (log_p, N.bit_length() - 1, sort) in built, (L, sort, T, N)
    assert bitonic.wide_block(L)[1] == (16 if L <= bitonic.WIDE_SHORT_L else 32)


@pytest.mark.parametrize("L", [8192, 32768])
@pytest.mark.parametrize("min_kk", [2, 32])
def test_wide_kernel_model_network_form_is_the_plain_network(L, min_kk):
    from binary_spgemm_tpu_torch.benchmarks.ab_wruns import alternating_runs

    x = torch.from_numpy(stream(2, L, L + min_kk, hi=1 << 30))
    runs = alternating_runs(x, 16)
    for inp in (x, runs):
        lk0 = bitonic._first_merge(min_kk, L)
        got, seen = wide_kernel_model(inp.numpy(), sort=False, lk0=lk0)
        assert np.array_equal(got, bitonic.bitonic_network_rows_plain(inp, min_kk).numpy())
        assert seen["skipped_warp_steps"] == 0
    assert np.array_equal(got, np.sort(x.numpy(), axis=1))  # runs of 16 from merge 32


@pytest.mark.parametrize("shape", sorted(WIDE_STEPS))
def test_wide_model_shared_memory_is_free_of_bank_conflicts(shape):
    """The 16-byte word swizzle: a register round trip's 16-byte accesses reach
    8 distinct bank groups in every phase of 8 threads; a shared step's and
    the load's and store's 32-bit accesses reach 32 distinct banks a warp."""
    P, T, N = shape
    log_p, log_n = P.bit_length() - 1, N.bit_length() - 1
    t = np.arange(T)
    slots = wide_swz(np.arange(1 << log_p), log_n)
    assert np.array_equal(np.sort(slots), np.arange(1 << log_p))  # a permutation
    for c in range(N // 4):
        w = wide_swz((t << log_n) + 4 * c, log_n)
        assert (w % 4 == 0).all()  # 16-byte aligned
        groups = (w // 4 % 8).reshape(-1, 8)
        assert all(len(set(g)) == 8 for g in groups)
    banks = (slots % 32).reshape(-1, 32)  # 32 consecutive slots: load, store
    assert all(len(set(b)) == 32 for b in banks)
    for lk in range(log_n + 6, log_p + 1):
        for lj in range(lk - 1, log_n + 4, -1):
            j = 1 << lj
            for q in range(N // 2):
                p = q * T + t
                i = 2 * p - (p & (j - 1))
                for u in (i + j, i ^ ((1 << lk) - 1)):
                    for s_ in (i, u):
                        b = (wide_swz(s_, log_n) % 32).reshape(-1, 32)
                        assert all(len(set(row)) == 32 for row in b)


# --- numpy model of sort_rows_warp_kernel ------------------------------------
# One warp a row (P >= 32) or 32 / P rows (P < 32): lane l holds the N = max(1,
# P / 32) contiguous slots N l ... N l + N - 1 of its warp's 32 N slots.  Steps
# with partner distance below N run inside the lane, the rest by shuffle.
# sort=True is K1's (and K2's) all-ascending form, each merge opening with the
# mirror step; sort=False the alternating form from merge 2^lk0 (P1/P2).


def _jax_padded(fn, x):
    """The JAX package's Pallas kernel ``fn`` (interpret mode) on ``x``'s rows
    padded with INT32_MAX to a power of two, and its row count to a multiple
    of 8 (the kernel's row block): the first L columns of the first k rows.
    The padding is the largest value, so these are the rows' own result."""
    k, L = x.shape
    P = 1 << (L - 1).bit_length()
    xp = np.full((-(-k // 8) * 8, P), I32_MAX, np.int32)
    xp[:k, :L] = x
    return np.asarray(fn(jnp.asarray(xp)))[:k, :L]


def warp_kernel_model(x, sort=True, lk0=1):
    """Run sort_rows_warp_kernel's schedule on int32 ``[k, L]`` ``x`` (L <=
    128), from the merge of size 2^lk0 on, holding every step against the
    whole network on the padded rows.  Returns the output, the padded rows
    as the registers hold them ([k, P], for K2's epilogue) and the steps run
    in each place."""
    k, L = x.shape
    log_p = (L - 1).bit_length()
    assert 0 <= log_p <= 7
    P = 1 << log_p
    log_n = max(0, log_p - 5)
    N = 1 << log_n
    row_lanes = P // N  # 32 from P = 32 up, else P
    lane = np.arange(32)
    n_warps = -(-k // (32 // row_lanes))
    row = np.arange(n_warps)[:, None] * (32 // row_lanes) + lane // row_lanes  # [W, 32]
    col = ((lane % row_lanes) << log_n)[:, None] + np.arange(N)  # [32, N]
    rows = np.broadcast_to(row[:, :, None], (n_warps, 32, N))
    cols = np.broadcast_to(col[None], rows.shape)
    ok = (rows < k) & (cols < L)
    r = np.full(rows.shape, I32_MAX, np.int32)  # rows past k: INT32_MAX
    r[ok] = x[rows[ok], cols[ok]]
    steps = {"register": 0, "shuffle": 0}
    ref = np.full((k, P), I32_MAX, np.int32)
    ref[:, :L] = x
    live = rows < k

    def ascending(i, lk):
        return np.ones(np.shape(i), bool) if sort or lk == log_p else (i & (1 << lk)) == 0

    for lk in range(lk0, log_p + 1):
        for lj in range(lk - 1, -1, -1):
            mirror = sort and lj == lk - 1
            if lj >= log_n:
                m = (1 << (lk - log_n)) - 1 if mirror else 1 << (lj - log_n)
                partner = lane ^ m  # __shfl_xor_sync(..., m)
                assert (partner // row_lanes == lane // row_lanes).all()  # inside the row
                o = r[:, partner, ::-1] if mirror else r[:, partner]
                lower = (lane & (1 << (lj - log_n))) == 0
                keep_min = lower == ascending(lane << log_n, lk)
                r = np.where(keep_min[None, :, None], np.minimum(r, o), np.maximum(r, o))
                steps["shuffle"] += 1
            else:
                j = 1 << lj
                new = r.copy()
                for e in range(N):
                    if e & j:
                        continue
                    f = e ^ ((1 << lk) - 1) if mirror else e | j
                    a, b = r[:, :, e], r[:, :, f]
                    up = ascending((lane << log_n) + e, lk)[None]
                    new[:, :, e] = np.where(up, np.minimum(a, b), np.maximum(a, b))
                    new[:, :, f] = np.where(up, np.maximum(a, b), np.minimum(a, b))
                r = new
                steps["register"] += 1
            _reference_step(ref, P, lk, lj, sort)
            held = np.full((k, P), I32_MAX, np.int32)
            held[rows[live], cols[live]] = r[live]
            assert np.array_equal(held, ref), (lk, lj)
    out = np.empty_like(x)
    out[rows[ok], cols[ok]] = r[ok]
    padded = np.full((k, P), I32_MAX, np.int32)
    padded[rows[live], cols[live]] = r[live]
    return out, padded, steps


WARP_LENGTHS = [1, 2, 3, 16, 37, 100, 128]


def _sort_case(k, L, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(I32_MIN, I32_MAX, (k, L), dtype=np.int64, endpoint=True)
    x = x.astype(np.int32)
    x[0, : min(3, L)] = I32_MAX
    x[-1, : min(2, L)] = I32_MIN
    x[k // 2, : max(1, L // 2)] = x[k // 2, 0]  # duplicates
    return x


@pytest.mark.parametrize("L", WARP_LENGTHS)
def test_warp_kernel_model_sorts_like_np_sort_and_jax(L):
    k = 13  # not a multiple of the rows a warp or a block holds
    x = _sort_case(k, L, L)
    assert bitonic.k1_variant(L) == "warp"
    got, padded, _ = warp_kernel_model(x)
    want = np.sort(x, axis=1)
    assert np.array_equal(got, want)
    assert np.array_equal(got, _jax_padded(
        lambda v: jx_bitonic.bitonic_sort_rows(v, interpret=True), x))
    assert np.array_equal(bitonic.bitonic_sort_rows(torch.from_numpy(x)).numpy(), want)
    assert (padded[:, L:] == I32_MAX).all()  # the padding sorts to the end


def test_warp_kernel_model_steps_match_the_source_note():
    note = " ".join(_wide_source().replace("//", " ").split())
    line = "Steps by place at P = 128: {} register, {} shuffle; P = 64: {} register, {} shuffle"
    steps = [warp_kernel_model(stream(2, P, P, hi=1 << 20))[2] for P in (128, 64)]
    assert line.format(*(v for st in steps for v in (st["register"], st["shuffle"]))) in note


@pytest.mark.parametrize("log_p", range(8))
def test_warp_kernel_model_step_placement(log_p):
    P = 1 << log_p
    x = stream(3, P, log_p) if P >= 3 else np.arange(3 * P, dtype=np.int32)[::-1].reshape(3, P)
    got, _, steps = warp_kernel_model(x)
    assert np.array_equal(got, np.sort(x, axis=1))
    log_n = max(0, log_p - 5)
    assert steps["register"] == sum(min(lk, log_n) for lk in range(1, log_p + 1))
    assert steps["register"] + steps["shuffle"] == log_p * (log_p + 1) // 2
    assert steps["shuffle"] <= 15  # the lane's five bits, at most 1 + 2 + ... + 5
    if log_p == 7:  # the window's longest row
        assert (steps["register"], steps["shuffle"]) == (13, 15)


@pytest.mark.parametrize("L", [1, 2, 16, 64, 128])
@pytest.mark.parametrize("first", ["2", "4", "32", "L", "2L"])
def test_warp_kernel_model_network_form_is_the_plain_network(L, first):
    from binary_spgemm_tpu_torch.benchmarks.ab_wruns import alternating_runs

    min_kk = {"L": L, "2L": 2 * L}.get(first) or int(first)
    x = torch.from_numpy(stream(9, L, L + min_kk, hi=1 << 30) if L >= 3 else
                         np.arange(9 * L, dtype=np.int32)[::-1].reshape(9, L).copy())
    runs = alternating_runs(x, max(1, min(16, L // 2)))
    lk0 = bitonic._first_merge(min_kk, L)
    for inp in (x, runs):
        got, _, _ = warp_kernel_model(inp.numpy(), sort=False, lk0=lk0)
        assert np.array_equal(got, bitonic.bitonic_network_rows_plain(inp, min_kk).numpy())
        assert np.array_equal(got, bitonic.bitonic_network_rows(inp, min_kk).numpy())


# --- numpy model of K2's epilogue ---------------------------------------------
# After K1's network the row's P slots lie sorted in its threads' registers,
# T = P / N threads of N contiguous slots (the warp kernel: N = max(1, P / 32),
# T <= 32 lanes of one warp; the register kernel: N = 8, T = P / 8 threads,
# whole warps; the wide kernel: bitonic.wide_block(L), the whole block).  Each
# thread keeps the slots that start the row or differ from their left
# neighbour and lie below the limit, counts them, and takes an exclusive scan
# of the counts over the row's threads: shuffles inside a warp (a segment of
# min(T, 32) lanes), then the warps' totals through shared memory; then it
# writes its kept values to their packed places, and INT32_MAX fills the row
# from its count to L.


def k2_epilogue_model(padded, L, limit, N, wide=False):
    """K2's epilogue on sorted padded rows ``padded`` [k, P] laid out in
    threads of N slots; ``wide``: the wide kernel, whose idle warps (every
    slot at or past L) keep nothing.  Returns the output rows and the
    number of shuffle rounds of the scan and of warps a row."""
    k, P = padded.shape
    T = P // N
    r = padded.reshape(k, T, N)
    t = np.arange(T)
    left = np.concatenate([np.zeros((k, 1), np.int32), r[:, :-1, N - 1]], axis=1)
    prev = np.concatenate([left[:, :, None], r[:, :, :-1]], axis=2)
    differs = r != prev
    differs[:, 0, 0] = True  # the row's first slot
    keep = differs & (r < limit)
    if wide:
        keep[:, ((t & ~31) * N) >= L] = False
    kept = keep.sum(axis=2)
    width = min(T, 32)
    inc, rounds, d = kept.copy(), 0, 1
    while d < width:  # __shfl_up_sync(..., d, width), every lane at once
        up = np.where((t % width >= d)[None], np.roll(inc, d, axis=1), 0)
        inc, rounds, d = inc + up, rounds + 1, 2 * d
    warp_total = inc[:, width - 1 :: width]
    before = np.cumsum(warp_total, axis=1) - warp_total  # through shared memory
    start = before[:, t // width] + inc - kept
    total = warp_total.sum(axis=1)
    hole = 1 << 40  # a place no kept value reached (not an int32)
    out = np.full((k, P), hole, np.int64)
    rank = np.cumsum(keep, axis=2) - keep
    rr, tt, ee = np.nonzero(keep)
    places = start[rr, tt] + rank[rr, tt, ee]
    assert len(set(zip(rr.tolist(), places.tolist()))) == len(places)  # no collision
    out[rr, places] = r[rr, tt, ee]
    c = np.arange(L)[None]
    assert (out[:, :L][c < total[:, None]] != hole).all()  # no hole below the count
    res = np.where(c < total[:, None], out[:, :L], I32_MAX).astype(np.int32)
    return res, rounds, T // width


K2_LAYOUTS = [("warp", L) for L in (1, 2, 3, 16, 37, 100, 128)] + [
    ("reg", L) for L in (129, 256, 700, 3968, 4096)] + [
    ("wide", L) for L in (4097, 4608, 7232, 8192, 16385, 32768)]


def _k2_case(L, seed):
    rng = np.random.default_rng(seed)
    k = 9
    x = rng.integers(-40, 3 * L + 40, (k, L)).astype(np.int32)  # duplicates
    x[0, : min(3, L)] = I32_MAX
    x[1, : min(2, L)] = I32_MIN
    x[2] = I32_MAX  # a row of nothing but the padding value
    x[3] = x[3, 0]  # a row of a single value
    return x


@pytest.mark.parametrize("limit", ["0", "mid", "max"])
@pytest.mark.parametrize("window,L", K2_LAYOUTS)
def test_k2_epilogue_model_equals_the_plain_version(window, L, limit):
    x = _k2_case(L, L)
    lim = {"0": 0, "mid": int(1.5 * L), "max": I32_MAX}[limit]
    assert bitonic.k1_variant(L) == window
    P = 1 << (L - 1).bit_length()
    if window == "warp":
        _, padded, _ = warp_kernel_model(x)
        N = max(1, P // 32)
    else:
        s = (reg_kernel_model(x) if window == "reg" else wide_kernel_model(x))[0]
        padded = np.concatenate([s, np.full((x.shape[0], P - L), I32_MAX, np.int32)], 1)
        N = 8 if window == "reg" else bitonic.wide_block(L)[1]
    got, rounds, warps = k2_epilogue_model(padded, L, lim, N, wide=window == "wide")
    want = bitonic.fused_sort_compress_plain(torch.from_numpy(x), lim).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(bitonic.fused_sort_compress(torch.from_numpy(x), lim).numpy(), want)
    assert (got[2] == I32_MAX).all()
    assert rounds == (P // N).bit_length() - 1 if P // N <= 32 else rounds == 5
    assert warps == max(1, P // N // 32)


@pytest.mark.parametrize("L", [1, 3, 37, 128, 256, 700, 4097])
def test_k2_epilogue_model_equals_jax_interpret(L):
    x = _k2_case(L, L + 1)
    P = 1 << (L - 1).bit_length()
    window = bitonic.k1_variant(L)
    for lim in (0, int(1.5 * L), I32_MAX):
        if window == "warp":
            padded, N = warp_kernel_model(x)[1], max(1, P // 32)
        else:
            padded, N = np.sort(np.concatenate(
                [x, np.full((x.shape[0], P - L), I32_MAX, np.int32)], 1), axis=1), (
                8 if window == "reg" else bitonic.wide_block(L)[1])
        got, _, _ = k2_epilogue_model(padded, L, lim, N, wide=window == "wide")
        want = _jax_padded(
            lambda v: jx_bitonic.fused_sort_compress(v, lim, interpret=True), x)
        assert np.array_equal(got, want), lim


def test_k2_variants_on_the_cpu_are_the_plain_version():
    bitonic.fused_sort_compress.launches = 0
    by_variant = dict(bitonic.fused_sort_compress.launches_by_variant)
    assert set(by_variant) == {"warp", "reg", "wide", "smem"}
    for L, variant in ((100, "warp"), (700, "reg"), (5000, "wide")):
        x = torch.from_numpy(_k2_case(L, 3))
        want = bitonic.fused_sort_compress_plain(x, L)
        for v in (variant, "smem"):
            assert torch.equal(bitonic._fused_sort_compress_variant(x, L, v), want)
    assert bitonic.fused_sort_compress.launches == 0
    assert bitonic.fused_sort_compress.launches_by_variant == by_variant
    x = torch.from_numpy(_k2_case(700, 3))
    with pytest.raises(ValueError, match="'warp' takes rows"):
        bitonic._fused_sort_compress_variant(x, 5, "warp")
    with pytest.raises(ValueError, match="unknown K2 variant"):
        bitonic._fused_sort_compress_variant(x, 5, "cub")
    with pytest.raises(ValueError, match="int32"):
        bitonic._fused_sort_compress_variant(x, -(1 << 31) - 1, "reg")


def test_k2_wide_shapes_built_are_the_ones_wide_block_picks():
    """The wrappers pass K2's wide kernel wide_block(L)'s shape, which the
    source builds in its compaction form."""
    import re

    src = _wide_source()
    body = src[src.index("cudaError_t launch_wide(const void*"):]
    body = body[: body.index("\n}\n")]
    built = {(int(lp), int(ln)) for lp, ln in
             re.findall(r"launch_wide_shape<(\d+), (\d+), true, true>", body)}
    picked = {((L - 1).bit_length(), bitonic.wide_block(L)[1].bit_length() - 1)
              for L in range(bitonic.WIDE_MIN_L, bitonic.WIDE_MAX_L + 1, 64)}
    assert built == picked == {(13, 4), (13, 5), (14, 5), (15, 5)}
