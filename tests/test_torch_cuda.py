"""The port's CUDA kernels and its main path on a card.  Every test here is
marked ``cuda`` and skips where ``torch.cuda.is_available()`` is false.
This file imports neither JAX nor the JAX package, so it runs on a machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import bitonic
from binary_spgemm_tpu_torch.utils.oracle import spgemm_oracle, union_oracle

pytestmark = pytest.mark.cuda

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "k,L", [(1024, 3968), (512, 4096), (333, 37), (16, bitonic.MAX_L), (7, 1)]
)
def test_kernels_equal_their_plain_versions(cuda_device, k, L):
    rng = np.random.default_rng(k + L)
    x = rng.integers(0, max(L // 2, 2), (k, L)).astype(np.int32)
    x[0, : min(3, L)] = I32_MAX
    x[-1, : min(2, L)] = I32_MIN
    xt = torch.from_numpy(x).to(cuda_device)
    limit = max(L // 3, 1)
    n1, n2 = bitonic.bitonic_sort_rows.launches, bitonic.fused_sort_compress.launches
    got1 = bitonic.bitonic_sort_rows(xt)
    got2 = bitonic.fused_sort_compress(xt, limit)
    torch.cuda.synchronize()
    assert torch.equal(got1, bitonic.bitonic_sort_rows_plain(xt))
    assert torch.equal(got2, bitonic.fused_sort_compress_plain(xt, limit))
    assert bitonic.bitonic_sort_rows.launches == n1 + 1
    assert bitonic.fused_sort_compress.launches == n2 + 1


WIDE_LENGTHS = [4097, 4352, 4608, 4864, 6912, 7232, 7552, 8096, 8192, 8193, 16384,
                16385, 17408, 32768]


@pytest.mark.parametrize(
    "k,L",
    [(64, 128), (64, 129), (64, 255), (64, 256), (64, 257), (40, 512),
     (24, 1000), (16, 1024), (32, 2048), (16, 3968), (16, 4095), (8, 4096),
     (16, 4097)] + [(max(8, (1 << 18) // L), L) for L in WIDE_LENGTHS[1:]],
)
def test_k1_variants_equal_the_plain_version(cuda_device, k, L):
    rng = np.random.default_rng(L)
    x = rng.integers(I32_MIN, I32_MAX, (k, L), dtype=np.int64, endpoint=True)
    x = x.astype(np.int32)
    x[0, :3] = I32_MAX
    x[-1, :2] = I32_MIN
    x[1] = x[1, 0]  # one row of a single value
    xt = torch.from_numpy(x).to(cuda_device)
    variant = bitonic.k1_variant(L)
    assert variant == ("warp" if L <= 128 else "reg" if L <= 4096 else "wide")
    before = dict(bitonic.bitonic_sort_rows.launches_by_variant)
    got = bitonic.bitonic_sort_rows(xt)
    torch.cuda.synchronize()
    assert torch.equal(got, bitonic.bitonic_sort_rows_plain(xt))
    after = bitonic.bitonic_sort_rows.launches_by_variant
    assert after[variant] == before[variant] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    if variant != "smem":  # the shared-memory kernel still takes these rows
        assert torch.equal(bitonic._sort_rows_variant(xt, "smem"), got)


WARP_LENGTHS = [1, 2, 3, 16, 37, 64, 100, 128]


@pytest.mark.parametrize("k", [1, 7, 65537])
@pytest.mark.parametrize("L", WARP_LENGTHS)
def test_warp_kernel_equals_the_plain_version(cuda_device, L, k):
    rng = np.random.default_rng(L * k)
    x = rng.integers(I32_MIN, I32_MAX, (k, L), dtype=np.int64, endpoint=True)
    x = x.astype(np.int32)
    x[0, : min(3, L)] = I32_MAX
    x[-1, : min(2, L)] = I32_MIN
    x[k // 2, : max(1, L // 2)] = x[k // 2, 0]  # duplicates
    xt = torch.from_numpy(x).to(cuda_device)
    assert bitonic.k1_variant(L) == "warp"
    n, before = bitonic.bitonic_sort_rows.launches, dict(
        bitonic.bitonic_sort_rows.launches_by_variant)
    got = bitonic.bitonic_sort_rows(xt)
    torch.cuda.synchronize()
    assert torch.equal(got, bitonic.bitonic_sort_rows_plain(xt))
    before["warp"] += 1
    assert bitonic.bitonic_sort_rows.launches == n + 1
    assert bitonic.bitonic_sort_rows.launches_by_variant == before
    # a row start that is not 16-byte aligned: the scalar loads and stores
    view = torch.empty(k * L + 1, dtype=torch.int32, device=cuda_device)[1:].view(k, L)
    view.copy_(xt)
    assert torch.equal(bitonic.bitonic_sort_rows(view), got)


@pytest.mark.parametrize("L", [1, 2, 4, 8, 16, 32, 64, 128])
def test_warp_network_at_every_first_merge(cuda_device, L):
    k = max(8, (1 << 15) // L)
    x, runs = runs_input(k, L, max(1, min(16, L // 2)), seed=L) if L > 1 else (
        torch.arange(k, dtype=torch.int32, device=cuda_device).view(k, 1), None)
    n = bitonic.bitonic_network_rows.launches
    for log_kk in range(1, L.bit_length() + 2):
        for inp in (x, runs) if runs is not None else (x,):
            got = bitonic.bitonic_network_rows(inp, 1 << log_kk)
            torch.cuda.synchronize()
            assert torch.equal(got, bitonic.bitonic_network_rows_plain(inp, 1 << log_kk)), (
                log_kk)
    assert bitonic.bitonic_network_rows.launches == n + (L.bit_length() + 1) * (
        2 if runs is not None else 1)


@pytest.mark.parametrize(
    "k,L", [(1024, 3968), (512, 7232), (333, 37), (16, bitonic.MAX_L), (7, 1), (64, 128),
            (65537, 16), (40, 129), (24, 4096), (16, 4097), (8, 16385)])
def test_k2_equals_its_plain_version_the_old_kernel_and_k1_twice(cuda_device, k, L):
    rng = np.random.default_rng(k + L)
    x = rng.integers(-5, max(L // 2, 2), (k, L)).astype(np.int32)  # duplicates
    x[0, : min(3, L)] = I32_MAX
    x[-1, : min(2, L)] = I32_MIN
    x[k // 2] = I32_MAX  # nothing kept
    xt = torch.from_numpy(x).to(cuda_device)
    variant = bitonic.k1_variant(L)
    for limit in (0, max(L // 3, 1), I32_MAX):
        n, before = bitonic.fused_sort_compress.launches, dict(
            bitonic.fused_sort_compress.launches_by_variant)
        got = bitonic.fused_sort_compress(xt, limit)
        torch.cuda.synchronize()
        before[variant] += 1
        assert bitonic.fused_sort_compress.launches == n + 1
        assert bitonic.fused_sort_compress.launches_by_variant == before
        assert torch.equal(got, bitonic.fused_sort_compress_plain(xt, limit)), limit
        assert torch.equal(bitonic._fused_sort_compress_variant(xt, limit, "smem"), got)
        s = bitonic.bitonic_sort_rows(xt)
        differs = torch.ones_like(s, dtype=torch.bool)  # the first slot of a row
        differs[:, 1:] = s[:, 1:] != s[:, :-1]
        keep = differs & (s < limit)
        assert torch.equal(bitonic.bitonic_sort_rows(torch.where(keep, s, I32_MAX)), got)


def test_kernels_raise_past_shared_memory(cuda_device):
    x = torch.zeros((1, bitonic.MAX_L + 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared-memory"):
        bitonic.bitonic_sort_rows(x)


def test_batched_executor_on_the_card(cuda_device):
    a = tp.BCSR.random(1 << 16, 1 << 16, 2.0, seed=31)
    ex = tp.auto_executor(a, a)
    assert ex.er_all.device.type == "cuda"
    from binary_spgemm_tpu_torch.ops import gather

    n1 = bitonic.bitonic_sort_rows.launches
    n34 = gather.class_gather.launches + gather.class_gather_keys.launches
    by_variant = dict(bitonic.bitonic_sort_rows.launches_by_variant)
    out = ex.run()
    torch.cuda.synchronize()
    assert bitonic.bitonic_sort_rows.launches == n1 + 2 * ex.n_groups
    if any(s is not None for s in ex.table_shapes):  # one P3 or P4 launch per group
        assert (gather.class_gather.launches + gather.class_gather_keys.launches
                == n34 + ex.n_groups)
    variant = bitonic.k1_variant(ex.sort_pad)
    by_variant[variant] += 2 * ex.n_groups
    assert bitonic.bitonic_sort_rows.launches_by_variant == by_variant
    assert ex.assemble(out).equals(spgemm_oracle(a, a))


def gather_case(w, g, pad, seed, nc=37, rows_pad=8, n_cols=1000):
    """A class table with sentinel tails, row ids with staged padding rows
    and one past the sentinel row, positions with out-of-range and negative
    ones (clamped as JAX's indexing clamps)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, n_cols, (nc, w)).astype(np.int32)
    lens = rng.integers(1, w + 1, nc)
    table[np.arange(w)[None, :] >= lens[:, None]] = n_cols
    rows = rng.integers(0, rows_pad, (g, pad)).astype(np.int32)
    rows[:, -2:] = rows_pad
    rows[0, 0] = rows_pad + 5
    pos = rng.integers(0, nc, (g, pad)).astype(np.int32)
    pos[:, -2:] = 0
    pos[-1, :4] = [nc, nc + 9, -1, -nc - 3]
    dev = torch.device("cuda")
    return (torch.from_numpy(table).to(dev), torch.from_numpy(pos).to(dev),
            torch.from_numpy(rows).to(dev), rows_pad, n_cols)


@pytest.mark.parametrize("w", [1, 2, 3, 16, 40, 10240])
def test_gathers_equal_their_plain_versions(cuda_device, w):
    from binary_spgemm_tpu_torch.ops import gather

    g, pad = (3, 6) if w == 10240 else (7, 45)
    table, pos, rows, rows_pad, n_cols = gather_case(w, g, pad, seed=w)
    shift = int(n_cols).bit_length()
    n3, n4 = gather.class_gather.launches, gather.class_gather_keys.launches
    r, c = gather.class_gather(table, pos, rows, rows_pad, n_cols)
    key = gather.class_gather_keys(table, pos, rows, rows_pad, n_cols, shift)
    torch.cuda.synchronize()
    want_r, want_c = gather.class_gather_plain(table, pos, rows, rows_pad, n_cols)
    assert torch.equal(r, want_r) and torch.equal(c, want_c)
    assert torch.equal(key, gather.class_gather_keys_plain(
        table, pos, rows, rows_pad, n_cols, shift))
    assert (want_r == rows_pad).any()  # sentinel rows and columns occur
    # into a column span of a wider stream, from column slices of wider inputs
    wide_pos = torch.zeros((g, pad + 3), dtype=torch.int32, device=cuda_device)
    wide_rows = torch.full_like(wide_pos, rows_pad)
    wide_pos[:, 3:], wide_rows[:, 3:] = pos, rows
    col0, span = 11, pad * w
    out = tuple(torch.full((g, span + 20), -7, dtype=torch.int32, device=cuda_device)
                for _ in range(3))
    gather.class_gather(table, wide_pos[:, 3:], wide_rows[:, 3:], rows_pad, n_cols,
                        out=out[:2], col0=col0)
    gather.class_gather_keys(table, wide_pos[:, 3:], wide_rows[:, 3:], rows_pad,
                             n_cols, shift, out=out[2], col0=col0)
    torch.cuda.synchronize()
    for o, want in zip(out, (want_r, want_c, key)):
        assert torch.equal(o[:, col0 : col0 + span], want)
        assert (o[:, :col0] == -7).all() and (o[:, col0 + span :] == -7).all()
    assert gather.class_gather.launches == n3 + 2
    assert gather.class_gather_keys.launches == n4 + 2


def group_gather_case(widths, g, pad, seed, rows_pad=8, n_cols=1000):
    """Classes of ``widths`` as one dispatch group: inputs as column slices
    of wider staged arrays, each class's span from an odd first column of a
    stream whose row stride is not a multiple of 4."""
    dev = torch.device("cuda")
    parts = [gather_case(w, g, pad, seed + k, nc=37 + k, rows_pad=rows_pad,
                         n_cols=n_cols) for k, w in enumerate(widths)]
    wide_pos = torch.cat([torch.zeros((g, 3), dtype=torch.int32, device=dev)]
                         + [p[1] for p in parts], dim=1)
    wide_rows = torch.cat([torch.full((g, 3), rows_pad, dtype=torch.int32, device=dev)]
                          + [p[2] for p in parts], dim=1)
    classes, off, col = [], 3, 5
    for (table, _, _, _, _), w in zip(parts, widths):
        classes.append((table, wide_pos[:, off : off + pad], wide_rows[:, off : off + pad],
                        col))
        off += pad
        col += pad * w
    width = col + 7 if (col + 7) % 4 else col + 6  # 7 or 6 columns past the spans
    return classes, width, rows_pad, n_cols


@pytest.mark.parametrize("case", ["widths 1-200", "w=10240", "past the cap"])
def test_group_gathers_equal_their_plain_versions(cuda_device, case):
    from binary_spgemm_tpu_torch.ops import gather

    if case == "widths 1-200":
        widths, g, pad = [1, 2, 3, 5, 7, 16, 40, 200], 7, 45
    elif case == "w=10240":
        widths, g, pad = [3, 10240, 5], 3, 6
    else:
        widths = np.random.default_rng(0).integers(1, 50, gather.GROUP_CAP + 11).tolist()
        g, pad = 4, 9
    classes, width, rows_pad, n_cols = group_gather_case(widths, g, pad, seed=len(widths))
    assert width % 4 and classes[0][3] % 2 and not classes[0][1].is_contiguous()
    shift = int(n_cols).bit_length()
    launches = -(-len(widths) // gather.GROUP_CAP)
    outs = [torch.full((g, width), -7, dtype=torch.int32, device=cuda_device)
            for _ in range(3)]
    want = [o.clone() for o in outs]
    n3, n4 = gather.class_gather.launches, gather.class_gather_keys.launches
    gather.class_gather_group(classes, rows_pad, n_cols, outs[:2])
    gather.class_gather_keys_group(classes, rows_pad, n_cols, shift, outs[2])
    torch.cuda.synchronize()
    assert gather.class_gather.launches == n3 + launches
    assert gather.class_gather_keys.launches == n4 + launches
    gather.class_gather_group_plain(classes, rows_pad, n_cols, want[:2])
    gather.class_gather_keys_group_plain(classes, rows_pad, n_cols, shift, want[2])
    for o, w_ in zip(outs, want):
        assert torch.equal(o, w_)
    assert (want[0] == rows_pad).any() and (want[0][:, :5] == -7).all()


def test_gathers_launch_nothing_on_empty_groups(cuda_device):
    from binary_spgemm_tpu_torch.ops import gather

    table = torch.zeros((4, 3), dtype=torch.int32, device=cuda_device)
    n3, n4 = gather.class_gather.launches, gather.class_gather_keys.launches
    for g, pad in ((0, 5), (2, 0)):
        z = torch.zeros((g, pad), dtype=torch.int32, device=cuda_device)
        assert gather.class_gather(table, z, z, 8, 100)[0].shape == (g, 3 * pad)
        assert gather.class_gather_keys(table, z, z, 8, 100, 7).shape == (g, 3 * pad)
    assert (gather.class_gather.launches, gather.class_gather_keys.launches) == (n3, n4)


@pytest.mark.parametrize("dealt", [False, True])
def test_unrolled_executor_on_the_card(cuda_device, dealt):
    from binary_spgemm_tpu_torch.ops import gather

    if dealt:
        a = tp.BCSR.rmat(10, 5.0, seed=61)
        ex = tp.EllSpGEMMExecutor(a, a, row_chunks="deal")
    else:
        a = tp.BCSR.random(3000, 3000, 4.0, seed=1)
        ex = tp.auto_executor(a, a)  # below 2^16 rows: the unrolled plan
    assert not ex.batched and (ex.row_sets is not None) == dealt
    assert ex.er_all.device.type == "cuda"
    gathered = sum(s is not None for s in ex.table_shapes)
    assert 0 < gathered <= gather.GROUP_CAP
    ref = spgemm_oracle(a, a)
    for _ in range(2):
        n3, n4 = gather.class_gather.launches, gather.class_gather_keys.launches
        c = ex.assemble(ex.run())
        assert gather.class_gather.launches == n3 + ex.n_groups  # one per group
        assert gather.class_gather_keys.launches == n4
        assert c.equals(ref)
    assert ex.run_assemble_streaming().equals(ref)


@pytest.mark.parametrize("L,route", [(32768, "k1"), (32769, "torch_sort")])
def test_sort_rows_at_the_kernels_bound(cuda_device, L, route):
    rng = np.random.default_rng(L)
    x = rng.integers(I32_MIN, I32_MAX, (3, L), dtype=np.int64, endpoint=True)
    xt = torch.from_numpy(x.astype(np.int32)).to(cuda_device)
    routes = dict(bitonic.sort_rows.routes)
    n1 = bitonic.bitonic_sort_rows.launches
    got = bitonic.sort_rows(xt)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.sort(xt, dim=1).values)
    routes[route] += 1
    assert bitonic.sort_rows.routes == routes
    assert bitonic.bitonic_sort_rows.launches == n1 + (route == "k1")


def test_heavy_row_product_on_the_card(cuda_device):
    """A 2^16 random pattern whose row 0 gets 12,000 more columns: batched,
    k = 64, sort_pad 172,032, so every sort takes torch.sort."""
    n = 65536
    a = tp.BCSR.random(n, n, 4.0, seed=1)
    r, c = a.to_coo()
    cols = np.random.default_rng(0).choice(n, 12000, replace=False)
    h = tp.BCSR.from_coo(np.concatenate([r, np.zeros(12000, np.int64)]),
                         np.concatenate([c, cols]), (n, n))
    ex = tp.auto_executor(h, h)
    assert ex.batched and (ex.n_chunks, ex.sort_pad) == (64, 172032)
    routes = dict(bitonic.sort_rows.routes)
    out = ex.run()
    torch.cuda.synchronize()
    assert bitonic.sort_rows.routes["torch_sort"] == routes["torch_sort"] + 2 * ex.n_groups
    got = ex.assemble(out)
    assert got.nnz == 1_130_438 and got.equals(spgemm_oracle(h, h))


def esc_operands(packable):
    """A packable product, or one whose (row, col) pairs need the int64
    two-key sort (a 2^26-column B)."""
    if packable:
        a = tp.BCSR.random(3000, 3000, 4.0, seed=5)
        return a, a
    rng = np.random.default_rng(12)
    m = 1 << 26
    a = tp.BCSR.from_coo(rng.integers(0, 2000, 8000), rng.integers(0, 500, 8000), (2000, 500))
    b = tp.BCSR.from_coo(rng.integers(0, 500, 6000), rng.integers(0, m, 6000), (500, m))
    return a, b


@pytest.mark.parametrize("packable", [True, False])
def test_esc_on_the_card_equals_the_cpu(cuda_device, packable):
    """``SpGEMMExecutor`` and one-shot ``spgemm(chunk_flops=)`` on the card
    equal the same calls with ``device="cpu"`` (stacked outputs over their
    valid prefixes, and the CSR), and launch no hand kernel."""
    from binary_spgemm_tpu_torch.ops import gather
    from binary_spgemm_tpu_torch.ops import spgemm as sp

    a, b = esc_operands(packable)
    assert sp.packable(a.n_rows, b.n_cols) == packable
    ref = spgemm_oracle(a, b)
    counts = lambda: (bitonic.bitonic_sort_rows.launches, dict(bitonic.sort_rows.routes),
                      gather.class_gather.launches, gather.class_gather_keys.launches)
    before = counts()
    for chunk_flops in (None, 5000):
        ex = tp.SpGEMMExecutor(a, b, chunk_flops=chunk_flops)
        cpu = tp.SpGEMMExecutor(a, b, chunk_flops=chunk_flops, device="cpu")
        assert ex.a_idx.device.type == "cuda" and ex.chunks == cpu.chunks
        (idx, nnz), (c_idx, c_nnz) = ex.run(), cpu.run()
        assert torch.equal(nnz.cpu(), c_nnz)
        for i in range(len(ex.chunks)):
            assert torch.equal(idx[i, : int(nnz[i])].cpu(), c_idx[i, : int(c_nnz[i])])
        c = ex.assemble((idx, nnz))
        assert c.equals(ref) and c.equals(cpu.assemble((c_idx, c_nnz)))
        if chunk_flops:
            assert len(ex.chunks) > 1
            one = tp.spgemm(a, b, chunk_flops=chunk_flops)
            assert one.equals(ref)
            assert one.equals(tp.spgemm(a, b, chunk_flops=chunk_flops, device="cpu"))
    assert counts() == before


def test_pull_prefix_on_the_card(cuda_device):
    from binary_spgemm_tpu_torch.ops import spgemm as sp

    flat = torch.arange(1 << 20, dtype=torch.int32, device=cuda_device) * 7
    want = flat.cpu().numpy()
    for total in (0, 1, 999_999, 1 << 20, (1 << 20) + 5):
        got = sp.pull_prefix(flat, total)
        assert got.dtype == np.int32 and np.array_equal(got, want[:total])


def k3_plan(b, n_a, n_b, group_sizes, seed, ones=False):
    """Random 0/1 bf16 tiles and a sorted, bucket-padded pair plan on the card."""
    from binary_spgemm_tpu_torch.ops.bsr import _pad_pair_plan

    rng = np.random.default_rng(seed)
    if ones:
        ta, tb = np.ones((n_a, b, b), np.uint8), np.ones((n_b, b, b), np.uint8)
    else:
        ta = (rng.random((n_a, b, b)) < 0.3).astype(np.uint8)
        tb = (rng.random((n_b, b, b)) < 0.3).astype(np.uint8)
    seg = np.repeat(np.arange(len(group_sizes)), group_sizes)
    ka, kb = rng.integers(0, n_a, len(seg)), rng.integers(0, n_b, len(seg))
    plan = _pad_pair_plan(ka, kb, seg, len(group_sizes))
    dev = torch.device("cuda")
    tiles = [torch.from_numpy(t).to(dev).to(torch.bfloat16) for t in (ta, tb)]
    return [torch.from_numpy(x).to(dev) for x in plan] + tiles


@pytest.mark.parametrize(
    "b,group_sizes,ones",
    [(128, [1, 2, 3, 1], False), (64, [4, 1], False), (32, [2, 5], False),
     (100, [3, 1], False), (7, [2, 2], False), (128, [230, 1], False),
     (128, [3, 2], True), (16, [4, 4, 4, 4], False)],  # the last has no padded tail
)
def test_k3_equals_its_plain_version(cuda_device, b, group_sizes, ones):
    from binary_spgemm_tpu_torch.ops import block_matmul as k3

    args = k3_plan(b, 9, 7, group_sizes, seed=b + len(group_sizes), ones=ones)
    n_out = len(group_sizes) + 1
    before = k3.grouped_block_matmul.launches
    by_variant = dict(k3.grouped_block_matmul.launches_by_variant)
    got = k3.grouped_block_matmul(*args, n_out=n_out)
    torch.cuda.synchronize()
    assert k3.grouped_block_matmul.launches == before + 1
    by_variant[k3.k3_variant(b, True)] += 1
    assert k3.grouped_block_matmul.launches_by_variant == by_variant
    assert torch.equal(got, k3.grouped_block_matmul_plain(*args, n_out=n_out))


def k3_cases():
    cases = []
    for b in (8, 16, 32, 64, 128):
        for variant in ("pipe", "simple"):
            cases.append((b, "1-3 pairs", variant))
    cases += [(100, "1-3 pairs", "simple"), (7, "1-3 pairs", "simple")]
    for variant in ("pipe", "simple"):
        cases += [(128, "230 pairs", variant), (64, "no pairs", variant),
                  (64, "4000 blocks", variant), (32, "skips blocks", variant)]
    return cases


@pytest.mark.parametrize("b,plan,variant", k3_cases())
def test_k3_variants_equal_the_plain_version(cuda_device, b, plan, variant):
    from binary_spgemm_tpu_torch.ops import block_matmul as k3

    rng = np.random.default_rng(b)
    if plan == "1-3 pairs":
        args, n_out = k3_plan(b, 9, 7, [1, 3, 2, 1, 2], seed=b), 6
    elif plan == "230 pairs":
        args, n_out = k3_plan(b, 9, 7, [230, 1, 2], seed=b), 4
    elif plan == "4000 blocks":  # each persistent block walks many output blocks
        groups = rng.integers(1, 4, 4000).tolist()
        args, n_out = k3_plan(b, 9, 7, groups, seed=b), 4001
    elif plan == "skips blocks":  # the first, a middle and the last block unvisited
        groups = [0, 2, 0, 3, 1, 0]
        args, n_out = k3_plan(b, 9, 7, groups, seed=b), 7
        npairs = sum(groups)
        args = [x[:npairs] for x in args[:4]] + args[4:]  # no padded tail
    else:  # no pairs at all: every block zeros
        empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
        tiles = k3_plan(b, 3, 3, [1], seed=b)[4:]
        args, n_out = [empty] * 4 + tiles, 5
    before = dict(k3.grouped_block_matmul.launches_by_variant)
    got = k3._grouped_block_matmul_variant(*args, n_out=n_out, variant=variant)
    torch.cuda.synchronize()
    assert k3.grouped_block_matmul.launches_by_variant[variant] == before[variant] + 1
    want = k3.grouped_block_matmul_plain(*args, n_out=n_out)
    assert torch.equal(got, want)
    if plan == "no pairs":
        assert not want.any()
    if plan == "skips blocks":
        assert not got[0].any() and not got[2].any() and not got[-1].any()


def test_blocked_executor_on_the_card(cuda_device):
    from binary_spgemm_tpu_torch.ops import block_matmul as k3
    from binary_spgemm_tpu_torch.ops.bsr import BsrStagedExecutor

    a = tp.BCSR.random_blocked(4096, 128, 2.0, 0.3, seed=3)
    ex = tp.auto_executor(a, a)
    assert isinstance(ex, BsrStagedExecutor) and ex._ex.a_dev.device.type == "cuda"
    ref = spgemm_oracle(a, a)
    for _ in range(2):
        n = k3.grouped_block_matmul.launches
        by_variant = dict(k3.grouped_block_matmul.launches_by_variant)
        c = ex.assemble(ex.run())
        assert k3.grouped_block_matmul.launches == n + 1
        by_variant["pipe"] += 1  # b = 128 in aligned tile arrays
        assert k3.grouped_block_matmul.launches_by_variant == by_variant
        assert c.equals(ref)
    assert tp.spgemm(a, a).equals(ref)


def runs_input(k, L, w, seed):
    """Random int32 rows with duplicates and extremes, and the same rows with
    each w-aligned block sorted, descending where ``(start & w) != 0``."""
    from binary_spgemm_tpu_torch.benchmarks.ab_wruns import alternating_runs

    rng = np.random.default_rng(seed)
    x = rng.integers(I32_MIN, I32_MAX, (k, L), dtype=np.int64, endpoint=True)
    x = x.astype(np.int32)
    x[0, : L // 2] = x[0, 0]
    x[1, :1] = I32_MAX
    x[-1, :1] = I32_MIN
    xt = torch.from_numpy(x).to(torch.device("cuda"))
    return xt, alternating_runs(xt, w)


@pytest.mark.parametrize("L", [128, 256, 4096, 8192, 16384, 32768])
@pytest.mark.parametrize("first", ["2", "4", "32", "L", "2L"])
def test_network_equals_its_plain_version(cuda_device, L, first):
    min_kk = {"L": L, "2L": 2 * L}.get(first) or int(first)
    k = max(8, (1 << 16) // L)
    w = min(16, L // 2)
    x, runs = runs_input(k, L, w, seed=L + min_kk)
    want_sorted = torch.sort(x, dim=1).values
    n = bitonic.bitonic_network_rows.launches
    for inp, label in ((x, "random"), (runs, "runs")):
        got = bitonic.bitonic_network_rows(inp, min_kk)
        torch.cuda.synchronize()
        assert torch.equal(got, bitonic.bitonic_network_rows_plain(inp, min_kk)), label
        if label == "runs" and min_kk <= 2 * w:
            assert torch.equal(got, want_sorted)
        if min_kk > L:
            assert torch.equal(got, inp) and got.data_ptr() != inp.data_ptr()
    assert bitonic.bitonic_network_rows.launches == n + 2


@pytest.mark.parametrize("k,L", [(2048, 4096), (512, 8192)])
def test_network_skip_on_runs_equals_torch_sort(cuda_device, k, L):
    x, runs = runs_input(k, L, 16, seed=k)
    got = bitonic.bitonic_network_rows(runs, 32)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.sort(x, dim=1).values)


@pytest.mark.parametrize(
    "L", [1, 37, 128, 129, 255, 256, 257, 512, 1000, 1024, 2048, 3968, 4095, 4096,
          4097, 32768])
def test_k1_unchanged_by_the_first_merge_argument(cuda_device, L):
    """K1 passes the first merge to the kernels it shares with the network:
    it still sorts, and at a power-of-two length equals the whole network."""
    x, _ = runs_input(max(16, (1 << 15) // L), L, 1, seed=L) if L > 1 else (
        torch.zeros((4, 1), dtype=torch.int32, device=cuda_device), None)
    got = bitonic.bitonic_sort_rows(x)
    torch.cuda.synchronize()
    assert torch.equal(got, bitonic.bitonic_sort_rows_plain(x))
    if L & (L - 1) == 0:
        assert torch.equal(bitonic.bitonic_network_rows(x, 2), got)


def or_oracle(d, a, b, f=None):
    from binary_spgemm_tpu_torch.utils.oracle import masked_spgemm_oracle

    return union_oracle(d, spgemm_oracle(a, b) if f is None else masked_spgemm_oracle(f, a, b))


def same_outputs(got, want):
    """Stacked ``run_*`` outputs equal over their valid prefixes (and the
    chunk-local row pointers, where there are some)."""
    got = [x.cpu() for x in got]
    assert [x.shape for x in got] == [x.shape for x in want]
    assert torch.equal(got[-1], want[-1])
    if len(got) == 3:
        assert torch.equal(got[0], want[0])
    for c in range(got[-1].shape[0]):
        n = int(got[-1][c])
        assert torch.equal(got[-2][c, :n], want[-2][c, :n])


@pytest.mark.parametrize("form", ["batched", "batched-pair", "unrolled", "dealt"])
def test_op_family_executor_on_the_card(cuda_device, form):
    """``run_masked``, ``run_or`` with and without a mask and ``run_padded``
    on the card equal the same calls on the CPU and scipy, with K1 (or
    ``torch.sort``) and P3/P4 launched where the plan says."""
    from binary_spgemm_tpu_torch.ops import gather
    from binary_spgemm_tpu_torch.ops import spgemm as sp
    from binary_spgemm_tpu_torch.utils.oracle import masked_spgemm_oracle

    n, m = (8000, 262145) if form == "batched-pair" else (3000, 3000)
    a = tp.BCSR.random(n, m, 3.0, seed=1)
    b = tp.BCSR.random(m, m, 0.2 if m > n else 2.0, seed=2)
    f, d = tp.BCSR.random(n, m, 4.0, seed=3), tp.BCSR.random(n, m, 1.5, seed=4)
    kw = {"batched": dict(batched=True, deal_k=64), "batched-pair": dict(batched=True, deal_k=6),
          "unrolled": {}, "dealt": dict(deal_k=16)}[form]
    ex = tp.EllSpGEMMExecutor(a, b, masked=True, **kw)
    cpu = tp.EllSpGEMMExecutor(a, b, masked=True, device="cpu", **kw)
    assert ex.batched == form.startswith("batched") and ex.n_chunks == cpu.n_chunks
    if form == "batched-pair":
        assert sp.packable(ex.rows_pad, 2 * m + 1) and not sp.packable(ex.rows_pad, 4 * m + 3)
    checks = [("masked", lambda e, x: e.run_masked(x(f)), masked_spgemm_oracle(f, a, b)),
              ("or", lambda e, x: e.run_or(x(d)), or_oracle(d, a, b)),
              ("or-masked", lambda e, x: e.run_or(x(d), mask=x(f)), or_oracle(d, a, b, f))]
    for label, run, ref in checks:
        k1, g = bitonic.bitonic_sort_rows.launches, (gather.class_gather.launches
                                                     + gather.class_gather_keys.launches)
        routes = dict(bitonic.sort_rows.routes)
        got = run(ex, ex.stage_mask)
        torch.cuda.synchronize()
        assert gather.class_gather.launches + gather.class_gather_keys.launches == g + ex.n_groups
        # every int32 join sorts through sort_rows: K1 within its window
        new = {r: bitonic.sort_rows.routes[r] - routes[r] for r in routes}
        assert bitonic.bitonic_sort_rows.launches - k1 == new["k1"]
        assert sum(new.values()) in (0, 2 * ex.n_groups)  # 0: the int64 joins
        same_outputs(got, run(cpu, cpu.stage_mask))
        assert ex.assemble(got).equals(ref), label
    if ex.batched:
        keys, nnz = ex.run_padded()
        c_keys, c_nnz = cpu.run_padded()
        assert torch.equal(keys.cpu(), c_keys) and torch.equal(nnz.cpu(), c_nnz)
        assert ex.assemble_padded((keys, nnz)).equals(spgemm_oracle(a, b))


@pytest.mark.parametrize("chunk_flops", [None, 20_000])
def test_op_family_one_shot_on_the_card(cuda_device, chunk_flops):
    """``masked_spgemm``, ``spgemm_or`` (with and without a mask) and
    ``spm_or`` past their host routes: the ELL routes, or ESC with
    ``chunk_flops``, equal to the CPU and scipy."""
    from binary_spgemm_tpu_torch.utils.oracle import masked_spgemm_oracle

    a = tp.BCSR.random(20000, 20000, 12.0, seed=7)
    f = tp.BCSR.random(20000, 20000, 6.0, seed=8)
    kw = {} if chunk_flops is None else {"chunk_flops": chunk_flops}
    c = tp.masked_spgemm(f, a, a, **kw)
    assert c.equals(masked_spgemm_oracle(f, a, a))
    assert c.equals(tp.masked_spgemm(f, a, a, device="cpu", **kw))
    for mask in (None, f):
        c = tp.spgemm_or(f, a, a, mask=mask, **kw)
        assert c.equals(or_oracle(f, a, a, mask))
        assert c.equals(tp.spgemm_or(f, a, a, mask=mask, device="cpu", **kw))
    assert tp.spm_or(a, f).equals(union_oracle(a, f))


def int_product(a, b, f=None):
    """scipy's int64 product (over F's support with ``f``), indices sorted."""
    c = a.to_scipy().astype(np.int64) @ b.to_scipy().astype(np.int64)
    if f is not None:
        c = c.multiply(f.to_scipy().astype(np.int64)).tocsr()
        c.eliminate_zeros()
    c.sort_indices()
    return c


def same_counts(got, ref):
    c, counts = got
    return (np.array_equal(c.indptr, ref.indptr) and np.array_equal(c.indices, ref.indices)
            and np.array_equal(counts, ref.data))


def symmetric_hollow(a):
    s = a.to_scipy()
    s = ((s + s.T) > 0).astype(np.int64).tolil()
    s.setdiag(0)
    return tp.BCSR.from_scipy(s.tocsr())


@pytest.mark.parametrize("form", ["batched", "batched-pair", "unrolled", "dealt"])
def test_counting_executor_on_the_card(cuda_device, form):
    """``run_counts``, ``run_masked_counts`` and ``run_counts_sum`` on the
    card equal the same calls on the CPU, their assembly scipy's integer
    product, with K1 counted wherever ``sort_rows`` took it and P3/P4 once a
    dispatch group."""
    from binary_spgemm_tpu_torch.ops import gather

    n, m = (8000, 262145) if form == "batched-pair" else (3000, 3000)
    a = tp.BCSR.random(n, m, 3.0, seed=1)
    b = tp.BCSR.random(m, m, 0.2 if m > n else 2.0, seed=2)
    f = tp.BCSR.random(n, m, 4.0, seed=3)
    kw = {"batched": dict(batched=True, deal_k=60), "batched-pair": dict(batched=True, deal_k=2),
          "unrolled": {}, "dealt": dict(deal_k=16)}[form]
    ex = tp.EllSpGEMMExecutor(a, b, masked=True, **kw)
    cpu = tp.EllSpGEMMExecutor(a, b, masked=True, device="cpu", **kw)
    assert ex.batched == form.startswith("batched") and ex.n_chunks == cpu.n_chunks
    for label, run, ref in (("counts", lambda e: e.run_counts(), int_product(a, b)),
                            ("masked", lambda e: e.run_masked_counts(e.stage_mask(f)),
                             int_product(a, b, f))):
        k1, g = bitonic.bitonic_sort_rows.launches, (gather.class_gather.launches
                                                     + gather.class_gather_keys.launches)
        routes = dict(bitonic.sort_rows.routes)
        got = run(ex)
        torch.cuda.synchronize()
        assert gather.class_gather.launches + gather.class_gather_keys.launches == g + ex.n_groups
        new = {r: bitonic.sort_rows.routes[r] - routes[r] for r in routes}
        assert bitonic.bitonic_sort_rows.launches - k1 == new["k1"]
        assert sum(new.values()) in (0, ex.n_groups)  # 0: the int64 pair keys
        if form == "batched":
            assert new == {"k1": ex.n_groups, "torch_sort": 0}
        want = run(cpu)
        got_c = [x.cpu() for x in got]
        assert [x.shape for x in got_c] == [x.shape for x in want]
        assert torch.equal(got_c[-1], want[-1])
        if len(got_c) == 4:
            assert torch.equal(got_c[0], want[0])
        for c in range(got_c[-1].shape[0]):
            nc = int(got_c[-1][c])
            for x, y in zip(got_c[-3:-1], want[-3:-1]):
                assert torch.equal(x[c, :nc], y[c, :nc])
        assert same_counts(ex.assemble_counts(got), ref), label
    sums = ex.run_counts_sum(f)
    assert sums.is_cuda and torch.equal(sums.cpu(), cpu.run_counts_sum(f))
    assert int(sums.sum()) == int(int_product(a, b, f).sum())


@pytest.mark.parametrize("chunk_flops", [None, 20_000])
def test_counting_entry_points_on_the_card(cuda_device, monkeypatch, chunk_flops):
    """``spgemm_counts``, ``masked_spgemm_counts`` and
    ``triangle_count_device`` past the host route on the card equal the CPU
    path and scipy: the batched ELL plans (forced, as the JAX tests force
    them at this size) with K1 launched, or ESC with ``chunk_flops``, which
    launches no hand kernel."""
    from binary_spgemm_tpu_torch.ops import counts, ell, gather

    if chunk_flops is None:
        monkeypatch.setattr(ell, "prefer_batched", lambda a, b: True)
    a = tp.BCSR.random(20000, 20000, 12.0, seed=7)
    f = tp.BCSR.random(20000, 20000, 6.0, seed=8)
    g = symmetric_hollow(tp.BCSR.random(20000, 20000, 4.0, seed=9))
    s = g.to_scipy()
    kw = {} if chunk_flops is None else {"chunk_flops": chunk_flops}
    for label, fn, ref in (
            ("spgemm_counts", lambda **d: tp.spgemm_counts(a, a, **kw, **d), int_product(a, a)),
            ("masked_spgemm_counts", lambda **d: tp.masked_spgemm_counts(f, a, a, **kw, **d),
             int_product(a, a, f)),
            ("triangle_count_device", lambda **d: counts.triangle_count_device(g, **kw, **d),
             int(s.multiply(s @ s).sum()) // 6)):
        k1 = bitonic.bitonic_sort_rows.launches
        gathers = gather.class_gather.launches + gather.class_gather_keys.launches
        got = fn()
        torch.cuda.synchronize()
        launched = (bitonic.bitonic_sort_rows.launches - k1,
                    gather.class_gather.launches + gather.class_gather_keys.launches - gathers)
        if chunk_flops is None:
            assert launched[0] > 0 and launched[1] > 0, label
        else:
            assert launched == (0, 0), label
        cpu = fn(device="cpu")
        if label == "triangle_count_device":
            assert got == cpu == ref and got > 0
        else:
            assert same_counts(got, ref) and same_counts(cpu, ref), label
            assert got[1].dtype == np.int64
    ell._EXEC_CACHE.clear()


def test_from_torch_takes_card_tensors(cuda_device):
    t = tp.BCSR.random(300, 200, 3.0, seed=4)
    st = t.to_torch()
    vals = torch.ones(t.nnz)
    vals[::5] = 0
    csr = torch.sparse_csr_tensor(st.crow_indices(), st.col_indices(), vals, size=t.shape)
    for x in (st, csr, csr.to_sparse_coo(), csr.to_dense()):
        got = tp.BCSR.from_torch(x.to(cuda_device))
        assert got.equals(tp.BCSR.from_torch(x))
    assert tp.BCSR.from_torch(st.to(cuda_device)).equals(t)


def same_device(x, y):
    """Two DeviceBCSR (one on the card) equal field by field, padded tails
    included."""
    return (tuple(x.shape) == tuple(y.shape) and int(x.nnz) == int(y.nnz)
            and torch.equal(x.indptr.cpu(), y.indptr.cpu())
            and torch.equal(x.indices.cpu(), y.indices.cpu()))


def same_stream(x, y):
    """Two one-sort streams (one on the card) element-equal over their whole
    length."""
    return (tuple(x.shape) == tuple(y.shape) and int(x.nnz) == int(y.nnz)
            and torch.equal(x.cols.cpu(), y.cols.cpu())
            and torch.equal(x.indptr_pos.cpu(), y.indptr_pos.cpu()))


@pytest.mark.parametrize("m", [3000, 1 << 22])
def test_device_api_on_the_card_equals_the_cpu(cuda_device, m):
    """Every op of ``ops/device_api.py`` on the card equals the same op on
    the CPU (whole padded arrays) and scipy, on packed keys and on a column
    count past them; no hand kernel runs."""
    from binary_spgemm_tpu_torch.ops import device_api as api, gather
    from binary_spgemm_tpu_torch.ops.spgemm import DeviceBCSR, pad_bucket, spgemm_flops
    from binary_spgemm_tpu_torch.utils.oracle import masked_spgemm_oracle

    a = tp.BCSR.random(3000, 3000, 6.0, seed=1).sum_duplicates()
    b = tp.BCSR.random(3000, m, 6.0, seed=2).sum_duplicates()
    f = tp.BCSR.random(3000, m, 4.0, seed=3).sum_duplicates()
    d = tp.BCSR.random(3000, m, 2.0, seed=4).sum_duplicates()
    fp = pad_bucket(spgemm_flops(a, b))
    on = {dev: [DeviceBCSR.from_host(x, require_canonical=True, device=dev)
                for x in (a, b, f, d)] for dev in ("cpu", cuda_device)}
    ops = {
        "spgemm": lambda a_, b_, f_, d_: api.spgemm_device(a_, b_, flops_pad=fp),
        "spm_or": lambda a_, b_, f_, d_: api.spm_or_device(f_, d_),
        "spgemm_or": lambda a_, b_, f_, d_: api.spgemm_or_device(d_, a_, b_, flops_pad=fp),
        "spgemm_or mask": lambda a_, b_, f_, d_: api.spgemm_or_device(d_, a_, b_, flops_pad=fp,
                                                                      mask=f_),
        "masked": lambda a_, b_, f_, d_: api.masked_spgemm_device(f_, a_, b_, flops_pad=fp),
    }
    launches = (bitonic.bitonic_sort_rows.launches, gather.class_gather.launches,
                gather.class_gather_keys.launches)
    for label, op in ops.items():
        got, cpu = op(*on[cuda_device]), op(*on["cpu"])
        assert got.indices.is_cuda and same_device(got, cpu), label
    assert got.to_host().equals(masked_spgemm_oracle(f, a, b))
    (gc, gn), (cc, cn) = (api.spgemm_counts_device(x[0], x[1], flops_pad=fp)
                          for x in (on[cuda_device], on["cpu"]))
    nnz = int(cc.nnz)
    assert same_device(gc, cc) and torch.equal(gn.cpu()[:nnz], cn[:nnz])
    assert np.array_equal(cn[:nnz].numpy(), int_product(a, b).data)
    (gc, gn), (cc, cn) = (api.masked_spgemm_counts_device(x[2], x[0], x[1], flops_pad=fp)
                          for x in (on[cuda_device], on["cpu"]))
    nnz = int(cc.nnz)
    assert same_device(gc, cc) and torch.equal(gn.cpu()[:nnz], cn[:nnz])
    assert int(api.counts_sum_device(on[cuda_device][2], on[cuda_device][0],
                                     on[cuda_device][1], flops_pad=fp)) == int(cn.sum())
    assert int(api.flops_bound_device(on[cuda_device][0], on[cuda_device][1])) == \
        spgemm_flops(a, b)
    assert launches == (bitonic.bitonic_sort_rows.launches, gather.class_gather.launches,
                        gather.class_gather_keys.launches)


@pytest.mark.parametrize("m", [3000, 1 << 20, 1 << 22])
def test_onesort_on_the_card_equals_the_cpu(cuda_device, m):
    """One-sort streams on the card element-equal to the CPU's over their
    whole length: the product, a hole-y chain, the fused OR with a hole-y
    seed, the masked join (packed, packed plain but unpacked join, pair
    key), and ``compact``."""
    from binary_spgemm_tpu_torch.ops import onesort as os_
    from binary_spgemm_tpu_torch.ops.spgemm import pad_bucket

    a = tp.BCSR.random(3000, 3000, 5.0, seed=5).sum_duplicates()
    b = tp.BCSR.random(3000, m, 5.0, seed=6).sum_duplicates()
    f = tp.BCSR.random(3000, m, 4.0, seed=7).sum_duplicates()
    res = {}
    for dev in ("cpu", cuda_device):
        pa, pb, pf = (os_.PaddedDeviceBCSR.from_host(x, device=dev) for x in (a, b, f))

        def pad(x, y):
            return pad_bucket(int(os_.flops_bound_onesort(x, y)[0]))

        p2 = os_.spgemm_onesort_device(pa, pa, flops_pad=pad(pa, pa))
        p3 = os_.spgemm_onesort_device(p2, pb, flops_pad=pad(p2, pb))
        seed = os_.spgemm_onesort_device(pa, pb, flops_pad=pad(pa, pb))
        fused = os_.spgemm_or_onesort_device(seed, pa, pb, flops_pad=pad(pa, pb))
        masked = os_.spgemm_or_onesort_device(seed, pa, pb, flops_pad=pad(pa, pb), mask=pf)
        res[str(dev)] = (p2, p3, fused, masked, p3.compact())
    for got, cpu in zip(res["cuda"][:4], res["cpu"][:4]):
        assert got.cols.is_cuda and same_stream(got, cpu)
    assert same_device(res["cuda"][4], res["cpu"][4])
    a2 = spgemm_oracle(a, a)
    assert res["cuda"][1].to_host().equals(spgemm_oracle(a2, b))


@pytest.fixture
def no_host_engine(monkeypatch):
    """Send every product of the host routes to the card's engines at test
    size (the host engine takes products up to HOST_MAX_FLOPS)."""
    from binary_spgemm_tpu_torch.ops import ell, host

    monkeypatch.setattr(host, "HOST_MAX_FLOPS", 0)
    monkeypatch.setattr(host, "HOST_OR_MAX_NNZ", 0)
    yield
    ell._EXEC_CACHE.clear()


def closure_oracle(a):
    r = (a.to_scipy() > 0).astype(np.int64)
    while True:
        nxt = ((r + r @ r) > 0).astype(np.int64)
        if nxt.nnz == r.nnz:
            return tp.BCSR.from_scipy(r.tocsr())
        r = nxt


def test_graph_routes_on_the_card(cuda_device, no_host_engine):
    """``k_hop`` and ``transitive_closure`` on the card: the host route with
    K1 and the gathers counted (every product through the ELL executors),
    the resident compacted and one-sort routes with none, each equal to the
    CPU and scipy."""
    from binary_spgemm_tpu_torch.ops import gather, graph

    a = tp.BCSR.random(3000, 3000, 0.9, seed=8)
    want = {"k_hop": spgemm_oracle(spgemm_oracle(a, a), a), "closure": closure_oracle(a)}
    for route, kw in (("host", {}), ("resident", {"resident": True, "one_sort": False}),
                      ("one-sort", {"resident": True})):
        for name, fn in (("k_hop", lambda **d: graph.k_hop(a, 3, **kw, **d)),
                         ("closure", lambda **d: graph.transitive_closure(a, **kw, **d))):
            k1 = bitonic.bitonic_sort_rows.launches + bitonic.sort_rows.routes["torch_sort"]
            g = gather.class_gather.launches + gather.class_gather_keys.launches
            got = fn()
            torch.cuda.synchronize()
            sorted_ = bitonic.bitonic_sort_rows.launches + bitonic.sort_rows.routes["torch_sort"] - k1
            gathered = gather.class_gather.launches + gather.class_gather_keys.launches - g
            if route == "host":
                assert sorted_ > 0 and gathered > 0, (route, name)
            else:
                assert (sorted_, gathered) == (0, 0), (route, name)
            assert got.equals(want[name]) and fn(device="cpu").equals(want[name]), (route, name)


def test_graph_ops_on_the_card(cuda_device, no_host_engine):
    """Triangles, clustering, the k-truss and BFS on the card equal the CPU
    and scipy; the masked products launch K1."""
    from binary_spgemm_tpu_torch.ops import graph

    g = symmetric_hollow(tp.BCSR.random(3000, 3000, 8.0, seed=9))
    s = g.to_scipy()
    support = s.multiply(s @ s).tocsr()
    k1 = bitonic.bitonic_sort_rows.launches + bitonic.sort_rows.routes["torch_sort"]
    ts = graph.triangle_structure(g)
    assert bitonic.bitonic_sort_rows.launches + bitonic.sort_rows.routes["torch_sort"] > k1
    support.eliminate_zeros()
    support.sort_indices()
    assert ts.equals(tp.BCSR(support.indptr, support.indices, g.shape))
    assert graph.triangle_count(g) == graph.triangle_count(g, device="cpu") == \
        int(support.sum()) // 6 > 0
    cc = graph.clustering_coefficients(g)
    assert np.array_equal(cc, graph.clustering_coefficients(g, device="cpu"))
    assert graph.k_truss(g, 3).equals(graph.k_truss(g, 3, device="cpu"))
    a = tp.BCSR.random(3000, 3000, 2.0, seed=10)
    assert np.array_equal(graph.bfs_levels(a, [0, 7]), graph.bfs_levels(a, [0, 7], device="cpu"))


@pytest.mark.parametrize("L", [128, 129, 4096, 4097, 32768, 32769])
@pytest.mark.parametrize("packable", [True, False])
def test_sort_compress_2d_on_the_card_equals_the_cpu(cuda_device, L, packable):
    """``sort_compress_2d`` on the card (K1 up to 32,768 slots where the
    pair packs, ``torch.sort`` past it and for the int64 pair key) equals
    the CPU's plain version on whole outputs."""
    from binary_spgemm_tpu_torch.ops import spgemm as sp

    n_rows, n_cols = (50, 300) if packable else (50, 1 << 26)
    rng = np.random.default_rng(L)
    row = torch.from_numpy(rng.integers(0, n_rows + 1, (3, L)).astype(np.int32))
    col = torch.from_numpy(rng.integers(0, 64, (3, L)).astype(np.int32))
    col[row == n_rows] = n_cols
    k1 = bitonic.bitonic_sort_rows.launches
    got = sp.sort_compress_2d(row.to(cuda_device), col.to(cuda_device), n_rows, n_cols)
    want = sp.sort_compress_2d(row, col, n_rows, n_cols)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bitonic.bitonic_sort_rows.launches - k1 == (2 if packable and L <= 32768 else 0)


def dist_cases(device):
    from binary_spgemm_tpu_torch.parallel import dist_spgemm as dist

    a = tp.BCSR.random(600, 600, 4.0, seed=21)
    f = tp.BCSR.random(600, 600, 12.0, seed=22)
    mod = "binary_spgemm_tpu_torch.parallel.dist_spgemm"
    cases = [(f"{lay}-{eng}", mod, "dist_spgemm", (a, a),
              {"b_layout": lay, "engine": eng, "device": device})
             for lay in ("replicated", "sharded", "ring") for eng in ("esc", "ell")]
    cases += [("masked", mod, "dist_masked_spgemm", (f, a, a), {"device": device}),
              ("or", mod, "dist_spgemm_or", (f, a, a), {"device": device}),
              ("or-masked", mod, "dist_spgemm_or", (f, a, a), {"mask": f, "device": device}),
              ("spm-or", mod, "dist_spm_or", (a, f), {"device": device})]
    return dist, a, f, [(*c, ()) for c in cases]


def test_dist_ops_on_the_card_equal_the_cpu(cuda_device):
    """The distributed ops in one process alone on the card: each equal to
    the same call on the CPU and to scipy, the ELL steps gathering with
    P3/P4 and sorting with K1 (rows of at most 32,768 slots here)."""
    from binary_spgemm_tpu_torch.ops import gather
    from binary_spgemm_tpu_torch.parallel.mesh import make_row_mesh
    from binary_spgemm_tpu_torch.utils.oracle import masked_spgemm_oracle

    import _torch_dist_cases

    dist, a, f, cases = dist_cases("cuda")
    card = _torch_dist_cases.run_cases(make_row_mesh(), cases)
    cpu = _torch_dist_cases.run_cases(make_row_mesh(device="cpu"), dist_cases("cpu")[3])
    prod = spgemm_oracle(a, a)
    want = {"masked": masked_spgemm_oracle(f, a, a), "or": union_oracle(f, prod),
            "or-masked": union_oracle(f, masked_spgemm_oracle(f, a, a)),
            "spm-or": union_oracle(a, f)}
    for name, res in card.items():
        assert res["c"].equals(want.get(name, prod)), name
        assert res["c"].equals(cpu[name]["c"]), name
        for p, q in zip(res["steps"], cpu[name]["steps"]):
            assert np.array_equal(p["c_ptr"], q["c_ptr"]) and p["total"] == q["total"]
    k1, p3, p4 = (bitonic.bitonic_sort_rows.launches, gather.class_gather.launches,
                  gather.class_gather_keys.launches)
    dist.dist_spgemm(a, a, engine="ell")
    assert bitonic.bitonic_sort_rows.launches > k1
    assert gather.class_gather.launches + gather.class_gather_keys.launches > p3 + p4


def test_dist_ranks_share_the_card(cuda_device):
    """Two gloo ranks on the one card: every op on both ranks equal to the
    same op in one process alone on the card."""
    from binary_spgemm_tpu_torch.parallel.launch import launch
    from binary_spgemm_tpu_torch.parallel.mesh import make_row_mesh

    import _torch_dist_cases

    cases = dist_cases("cuda")[3]
    alone = _torch_dist_cases.run_cases(make_row_mesh(), cases)
    res = launch(_torch_dist_cases.run_cases, 2, cases, device="cuda", timeout=300)
    for rank in res:
        for name, got in rank.items():
            assert got["c"].equals(alone[name]["c"]), name


def dist_count_cases(device):
    """The distributed counting family, triangles, the closure and k-hop at
    test size (``run_cases`` cases on ``device``)."""
    from binary_spgemm_tpu_torch.ops import graph

    a = tp.BCSR.random(600, 600, 4.0, seed=21)
    f = tp.BCSR.random(600, 600, 12.0, seed=22)
    g = symmetric_hollow(a)
    r = tp.BCSR.random(900, 900, 1.2, seed=9)
    mod = "binary_spgemm_tpu_torch.parallel.dist_spgemm"
    one = "binary_spgemm_tpu_torch.parallel.dist_onesort"
    kw = {"device": device}
    cases = [(f"counts-{eng}", mod, "dist_spgemm_counts", (a, a), {"engine": eng, **kw})
             for eng in ("esc", "ell")]
    cases += [(f"masked-counts-{eng}", mod, "dist_masked_spgemm_counts", (f, a, a),
               {"engine": eng, **kw}) for eng in ("esc", "ell")]
    cases += [(f"triangles-{eng}", mod, "dist_triangle_count", (g,), {"engine": eng, **kw})
              for eng in ("esc", "ell")]
    cases += [("closure", one, "dist_transitive_closure", (r,), kw)]
    cases += [(f"k_hop-{k}", one, "dist_k_hop", (a,), {"k": k, **kw}) for k in (2, 3)]
    want = {"closure": graph.transitive_closure(r, device="cpu"),
            "k_hop-2": graph.k_hop(a, 2, device="cpu"),
            "k_hop-3": graph.k_hop(a, 3, device="cpu")}
    return [(*c, ()) for c in cases], want


def same_result(x, y) -> bool:
    if isinstance(x, tuple):
        return x[0].equals(y[0]) and np.array_equal(x[1], y[1])
    if isinstance(x, int):
        return x == y
    return x.equals(y)


def test_dist_counting_on_the_card_equals_the_cpu(cuda_device):
    """The distributed counting family, triangles, closure and k-hop in one
    process alone on the card: each equal to the same call on the CPU (and
    the closure and k-hop to the host routes), the counting steps on the
    card, the ELL counts launching K1 (rows within its window here) and
    P3/P4."""
    from binary_spgemm_tpu_torch.ops import gather
    from binary_spgemm_tpu_torch.parallel import dist_spgemm as dist
    from binary_spgemm_tpu_torch.parallel.mesh import make_row_mesh

    import _torch_dist_cases

    cases, want = dist_count_cases("cuda")
    card = _torch_dist_cases.run_cases(make_row_mesh(), cases)
    cpu = _torch_dist_cases.run_cases(make_row_mesh(device="cpu"), dist_count_cases("cpu")[0])
    for name, res in card.items():
        assert "error" not in res, (name, res)
        assert same_result(res["c"], cpu[name]["c"]), name
        if name in want:
            assert res["c"].equals(want[name]), name
        for p, q in zip(res["steps"], cpu[name]["steps"]):
            assert np.array_equal(p["c_ptr"], q["c_ptr"]) and p["total"] == q["total"]
            for x, y in zip(p["cnt"], q["cnt"]):
                assert np.array_equal(x, y)
    a = tp.BCSR.random(600, 600, 4.0, seed=21)
    k1, p34 = (bitonic.bitonic_sort_rows.launches,
               gather.class_gather.launches + gather.class_gather_keys.launches)
    dist.dist_spgemm_counts(a, a, engine="ell")
    assert bitonic.bitonic_sort_rows.launches > k1
    assert gather.class_gather.launches + gather.class_gather_keys.launches > p34


def test_dist_counting_ranks_share_the_card(cuda_device):
    """Two gloo ranks on the one card: the counting family, triangles,
    closure and k-hop on both ranks equal to the same call in one process
    alone on the card."""
    from binary_spgemm_tpu_torch.parallel.launch import launch
    from binary_spgemm_tpu_torch.parallel.mesh import make_row_mesh

    import _torch_dist_cases

    cases, _ = dist_count_cases("cuda")
    alone = _torch_dist_cases.run_cases(make_row_mesh(), cases)
    res = launch(_torch_dist_cases.run_cases, 2, cases, device="cuda", timeout=300)
    for rank in res:
        for name, got in rank.items():
            assert same_result(got["c"], alone[name]["c"]), name


@pytest.mark.parametrize("n_ranks, backend, staged", [(1, "nccl", 0), (2, "gloo", 32)])
def test_all_reduce_sum_on_the_card(cuda_device, n_ranks, backend, staged):
    """``comm.all_reduce_sum`` of card tensors: under NCCL (one rank, its
    own card) it stays on the card; under gloo (ranks sharing the card) it
    stages through the host, down and up."""
    from binary_spgemm_tpu_torch.parallel.launch import launch

    import _torch_dist_cases

    facts = launch(_torch_dist_cases.reduce_facts, n_ranks, device="cuda", timeout=300)
    S = n_ranks
    for f in facts:
        assert f["backend"] == backend and f["device"].startswith("cuda")
        assert list(f["sum"]) == [S * (S - 1) // 2, S * (1 << 40) + S * (S - 1) // 2]
        assert f["counters"] == {"calls": 1, "bytes": 16, "staged_bytes": staged}
