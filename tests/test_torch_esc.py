"""The port's chunked expand–sort–compress (ESC) engine against the JAX
package's, on the CPU: the expansion streams element-equal over the whole
padded length (sentinels included), the compaction steps equal over their
valid prefixes (row pointers and counts equal), the chunk plans equal field
by field, ``SpGEMMExecutor`` and ``spgemm(chunk_flops=)`` bit-exact against
the JAX package and scipy, ``tuned_executor``'s candidates, the pipelined
stitch and the prefix pull.  Exact equality everywhere."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.formats import bcsr as jx_bcsr
from binary_spgemm_tpu.ops import ell as jx_ell
from binary_spgemm_tpu.ops import spgemm as jx_sp

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.formats import bcsr as tp_bcsr
from binary_spgemm_tpu_torch.ops import bitonic
from binary_spgemm_tpu_torch.ops import ell as tp_ell
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp
from binary_spgemm_tpu_torch.utils import trace
from binary_spgemm_tpu_torch.utils.oracle import masked_spgemm_oracle, spgemm_oracle


def to_port(m):
    return tp.bcsr_from_arrays(m.indptr, m.indices, m.shape)


def assert_same(j, t):
    assert np.array_equal(j.indptr, t.indptr)
    assert np.array_equal(j.indices, t.indices)


def padded(mat, nnz_pad, seed):
    """``mat`` as ``(indptr int32, indices padded to nnz_pad with garbage
    columns, nnz)``: entries past nnz must expand to nothing."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, max(mat.n_cols, 1), nnz_pad).astype(np.int32)
    idx[: mat.nnz] = mat.indices
    return mat.indptr.astype(np.int32), idx, mat.nnz


def with_empty_rows(mat, every, seed):
    """``mat`` with every ``every``-th row emptied."""
    r, c = mat.to_coo()
    keep = r % every != 0
    return jx.BCSR.from_coo(r[keep], c[keep], mat.shape)


def both_expansions(a_ptr, a_idx, a_nnz, b_ptr, b_idx, n_cols, flops_pad, **win):
    jwin = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in win.items()}
    twin = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in win.items()}
    j = jax.jit(jx_sp.expand_pairs, static_argnames=("n_cols", "flops_pad"))(
        jnp.asarray(a_ptr), jnp.asarray(a_idx), jnp.asarray(a_nnz, jnp.int32),
        None if b_ptr is None else jnp.asarray(b_ptr), jnp.asarray(b_idx),
        n_cols=n_cols, flops_pad=flops_pad, **jwin)
    t = tp_sp.expand_pairs(
        torch.from_numpy(a_ptr), torch.from_numpy(a_idx), a_nnz,
        None if b_ptr is None else torch.from_numpy(b_ptr), torch.from_numpy(b_idx),
        n_cols=n_cols, flops_pad=flops_pad, **twin)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


EXPAND_CASES = [
    # (n, k, m, d, seed, empty-row stride, extra nnz padding, extra flops padding)
    (60, 50, 70, 3.0, 1, 0, 0, 0),
    (60, 50, 70, 3.0, 2, 3, 17, 40),   # empty rows, padded A tail, slack slots
    (1, 40, 30, 8.0, 3, 0, 5, 3),      # one row
    (200, 120, 1 << 20, 2.0, 4, 5, 9, 11),  # wide B (two-key downstream)
    (80, 60, 40, 0.5, 5, 2, 3, 7),     # mostly empty rows, B rows empty too
]


@pytest.mark.parametrize("n,k,m,d,seed,every,xnnz,xflops", EXPAND_CASES)
def test_expand_pairs_matches_jax(n, k, m, d, seed, every, xnnz, xflops):
    a = jx.BCSR.random(n, k, d, seed=seed)
    if every:
        a = with_empty_rows(a, every, seed)
    b = jx.BCSR.random(k, m, d, seed=seed + 50)
    total = jx_sp.spgemm_flops(a, b)
    a_ptr, a_idx, a_nnz = padded(a, a.nnz + xnnz, seed)
    (jr, jc), (tr, tc) = both_expansions(
        a_ptr, a_idx, a_nnz, b.indptr.astype(np.int32), b.indices, m, total + xflops)
    assert tr.dtype == np.int32 and tc.dtype == np.int32
    assert np.array_equal(jr, tr) and np.array_equal(jc, tc)
    # the sentinel tail, and the candidates themselves
    assert (tr[total:] == n).all() and (tc[total:] == m).all()
    want = sorted(
        (i, int(col)) for i in range(n)
        for j in a.indices[a.indptr[i]:a.indptr[i + 1]]
        for col in b.indices[b.indptr[j]:b.indptr[j + 1]]
    )
    assert sorted(zip(tr[:total].tolist(), tc[:total].tolist())) == want


def test_expand_pairs_no_a_entries():
    a = jx.BCSR.random(30, 20, 2.0, seed=7)
    b = jx.BCSR.random(20, 25, 2.0, seed=8)
    a_ptr, a_idx, _ = padded(a, a.nnz + 4, 7)
    (jr, jc), (tr, tc) = both_expansions(
        a_ptr, a_idx, 0, b.indptr.astype(np.int32), b.indices, 25, 64)
    assert np.array_equal(jr, tr) and np.array_equal(jc, tc)
    assert (tr == 30).all() and (tc == 25).all()


@pytest.mark.parametrize("base,n_local,gap", [(0, 40, 3), (13, 17, 0), (25, 15, 5)])
def test_expand_pairs_windowed_matches_jax(base, n_local, gap):
    """B's rows addressed through ``b_row_starts``/``b_row_lens`` with gaps
    between rows, restricted to the window ``[base, base + n_local)``: the
    A-entries outside it expand to nothing."""
    a = jx.BCSR.random(50, 40, 4.0, seed=base + 1)
    b = jx.BCSR.random(40, 60, 3.0, seed=base + 2)
    lens = np.diff(b.indptr).astype(np.int32)
    starts = (b.indptr[:-1] + gap * np.arange(40)).astype(np.int32)
    flat = np.full(int(starts[-1] + lens[-1]) + gap, 59, np.int32)
    for j in range(40):
        flat[starts[j] : starts[j] + lens[j]] = b.indices[b.indptr[j] : b.indptr[j + 1]]
    rows = slice(base, base + n_local)
    in_win = (a.indices >= base) & (a.indices < base + n_local)
    total = int(lens[a.indices[in_win]].sum())
    a_ptr, a_idx, a_nnz = padded(a, a.nnz + 6, base)
    (jr, jc), (tr, tc) = both_expansions(
        a_ptr, a_idx, a_nnz, None, flat, 60, total + 9,
        b_row_starts=starts[rows].copy(), b_row_lens=lens[rows].copy(), b_col_base=base)
    assert np.array_equal(jr, tr) and np.array_equal(jc, tc)
    assert (tr[:total] < 50).all() and (tr[total:] == 50).all()


def test_flops_pad_below_the_total_raises():
    """The JAX expansion keeps the first ``flops_pad`` candidates and drops
    the rest without a signal; the port raises."""
    a = jx.BCSR.random(40, 40, 3.0, seed=9)
    total = jx_sp.spgemm_flops(a, a)
    a_ptr, a_idx, a_nnz = padded(a, a.nnz, 9)
    jr, _ = jx_sp.expand_pairs(
        jnp.asarray(a_ptr), jnp.asarray(a_idx), jnp.asarray(a_nnz, jnp.int32),
        jnp.asarray(a_ptr), jnp.asarray(a_idx), n_cols=40, flops_pad=total - 5)
    assert (np.asarray(jr) < 40).all()  # JAX: every slot valid, 5 candidates gone
    args = [torch.from_numpy(x) for x in (a_ptr, a_idx)]
    for fn in (tp_sp.expand_pairs, tp_sp.esc_spgemm, tp_sp.esc_spgemm_seps):
        with pytest.raises(ValueError, match="drop candidates"):
            fn(*args, a_nnz, *args, n_cols=40, flops_pad=total - 5)
    # exactly the total is enough
    tp_sp.expand_pairs(*args, a_nnz, *args, n_cols=40, flops_pad=total)


def stream(n_rows, n_cols, n_slots, n_pad, seed):
    """Candidate pairs with duplicates and an ``(n_rows, n_cols)`` sentinel
    tail of ``n_pad`` slots."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n_rows, n_slots).astype(np.int32)
    col = rng.integers(0, min(n_cols, 97), n_slots).astype(np.int32)
    col[::3] = rng.integers(0, n_cols, len(col[::3]))
    row[n_slots - n_pad :] = n_rows
    col[n_slots - n_pad :] = n_cols
    return row, col


# n_rows 37 at 400 slots takes the histogram, 20 the searchsorted; n_cols
# 1 << 26 makes the pair unpackable (two-key)
COMPRESS_CASES = [(37, 53), (20, 53), (37, 1 << 26), (20, 1 << 26)]


@pytest.mark.parametrize("n_rows,n_cols", COMPRESS_CASES)
def test_sort_compress_matches_jax(n_rows, n_cols):
    row, col = stream(n_rows, n_cols, 400, 50, n_rows + n_cols)
    assert tp_sp.packable(n_rows, n_cols) == (n_cols == 53)
    assert tp_sp._histogram_indptr_wins(n_rows, 400) == (n_rows == 37)
    j_ptr, j_idx, j_nnz = (np.asarray(x) for x in jx_sp.sort_compress(
        jnp.asarray(row), jnp.asarray(col), n_rows, n_cols))
    t_ptr, t_idx, t_nnz = (x.numpy() for x in tp_sp.sort_compress(
        torch.from_numpy(row), torch.from_numpy(col), n_rows, n_cols))
    assert t_ptr.dtype == t_idx.dtype == t_nnz.dtype == np.int32
    assert int(t_nnz) == int(j_nnz)
    assert np.array_equal(t_ptr, j_ptr)
    assert np.array_equal(t_idx[: int(t_nnz)], j_idx[: int(j_nnz)])
    # and the product is the deduplicated pair set
    pairs = sorted(set(zip(row[:350].tolist(), col[:350].tolist())))
    assert int(t_nnz) == len(pairs)
    assert t_idx[: int(t_nnz)].tolist() == [c for _, c in pairs]


def test_histogram_rule_matches_jax():
    for n_rows in (1, 20, 37, 1000, 8192, 155_000):
        for n_slots in (0, 1, 400, 1 << 20, 2_600_000):
            assert tp_sp._histogram_indptr_wins(n_rows, n_slots) == (
                jx_sp._histogram_indptr_wins(n_rows, n_slots))


# a stack's rows of 512 slots: ceil(log2 512) = 9 reads a bound, so the
# searchsorted reads no more than the histogram's 512 scatters up to
# n_rows = 55 (40 takes it, 60 keeps the histogram)
STACK_L = 512
# the row field of a demoted INT32_MAX key: packed at 6 column bits, or the
# int64 pair key's high word
DEMOTED_ROW = {torch.int32: ((1 << 31) - 1) >> 6, torch.int64: (1 << 31) - 1}


def sorted_row_stack(lead, n_rows, fill, dtype, seed):
    """Row ids ``lead + (STACK_L,)``, each row sorted: ``tail`` every slot
    past the real rows, ``real`` none, ``gaps`` empty leading, middle and
    trailing rows and a tail of any length (none and all included).  Tail
    ids are ``n_rows`` (a demoted pair key's row) and the row field of a
    demoted ``INT32_MAX`` packed key."""
    rng = np.random.default_rng(seed)
    if fill == "gaps":
        real = np.setdiff1d(np.arange(n_rows), np.r_[0:3, n_rows // 2 - 2:n_rows // 2 + 2,
                                                     n_rows - 4:n_rows])
        x = rng.choice(real, (*lead, STACK_L))
        n_tail = rng.integers(0, STACK_L + 1, lead)
        n_tail.reshape(-1)[:2] = (0, STACK_L)
        tail_slot = np.arange(STACK_L) >= STACK_L - n_tail[..., None]
    else:
        x = rng.integers(0, n_rows, (*lead, STACK_L))
        tail_slot = np.full(x.shape, fill == "tail")
    x = np.where(tail_slot, rng.choice([n_rows, DEMOTED_ROW[dtype]], x.shape), x)
    return torch.from_numpy(np.sort(x, axis=-1)).to(dtype)


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
@pytest.mark.parametrize("n_rows", [40, 60])
@pytest.mark.parametrize("fill", ["tail", "real", "gaps"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_stacked_indptr_forms_agree(dtype, fill, n_rows, lead):
    """A stack's searchsorted pointers equal its histogram's and each row's
    JAX pointers, on either side of the shape rule; ``_indptr`` takes the
    form the rule picks and counts it."""
    x = sorted_row_stack(lead, n_rows, fill, dtype, n_rows + len(lead))
    want = tp_sp._indptr_from_sorted_rows(x, n_rows)
    assert want.shape == (*lead, n_rows + 1)
    for row, ptr in zip(x.reshape(-1, STACK_L), want.reshape(-1, n_rows + 1)):
        j = jx_sp._indptr_from_sorted_rows(jnp.asarray(row.numpy()), n_rows)
        assert np.array_equal(ptr.numpy(), np.asarray(j))
    search = tp_sp._indptr_search(x, n_rows)
    assert search.dtype == torch.int32 and torch.equal(search, want)
    takes_search = n_rows == 40
    assert tp_sp._search_indptr_wins(n_rows, STACK_L) == takes_search
    trace.reset()
    with trace.tracing(), trace.span("call.indptr"):
        got = tp_sp._indptr(x, n_rows)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    (root,) = trace.spans()
    assert root.counts == {"indptr.search" if takes_search else "indptr.histogram": 1}


def test_indptr_counts_the_form_each_compress_takes():
    """``sort_compress_2d_keys`` on a stack (the distributed step's
    compress) forms its pointers by the searchsorted, once; a 1-D
    ``sort_compress`` keeps the form ``_histogram_indptr_wins`` picks, the
    histogram at the ESC cell's chunk shape (2^25 flops over 1,441,792
    padded rows) and at this 1-D stream's, which as a stack would search."""
    n_rows, n_cols, C = 40, 53, 4
    assert tp_sp._search_indptr_wins(n_rows, STACK_L)
    rows = [stream(n_rows, n_cols, STACK_L, 70 * c, c) for c in range(C)]
    row = torch.from_numpy(np.stack([r for r, _ in rows]))
    col = torch.from_numpy(np.stack([c for _, c in rows]))
    key = (row << int(n_cols).bit_length()) | col
    trace.reset()
    with trace.tracing(), trace.span("call.stack"):
        ptr, idx, nnz = tp_sp.sort_compress_2d_keys(key, n_rows, n_cols)
    (root,) = [s for s in trace.spans() if s.parent is None]
    assert root.counts == {"sort.slots": 2 * C * STACK_L, "indptr.search": 1}
    for c in range(C):  # each row is its own 1-D compress
        w_ptr, w_idx, w_nnz = tp_sp.sort_compress(row[c], col[c], n_rows, n_cols)
        assert torch.equal(ptr[c], w_ptr) and int(nnz[c]) == int(w_nnz)
        assert torch.equal(idx[c, : int(w_nnz)], w_idx[: int(w_nnz)])

    assert tp_sp._histogram_indptr_wins(1_441_792, (1 << 25) + 1_441_792)
    row, col = stream(37, 53, 400, 50, 7)
    assert tp_sp._histogram_indptr_wins(37, 400) and tp_sp._search_indptr_wins(37, 400)
    trace.reset()
    with trace.tracing(), trace.span("call.esc"):
        ptr, _, _ = tp_sp.sort_compress(torch.from_numpy(row), torch.from_numpy(col), 37, 53)
    (root,) = [s for s in trace.spans() if s.parent is None]
    assert root.counts["indptr.histogram"] == 1 and "indptr.search" not in root.counts
    j_ptr, _, _ = jx_sp.sort_compress(jnp.asarray(row), jnp.asarray(col), 37, 53)
    assert np.array_equal(ptr.numpy(), np.asarray(j_ptr))


@pytest.mark.parametrize("n_rows,n_cols", COMPRESS_CASES[::2])
def test_sort_compress_seps_matches_jax(n_rows, n_cols):
    row, col = stream(n_rows, n_cols, 400, 50, n_rows)
    row = np.concatenate([row, np.arange(n_rows, dtype=np.int32)])
    col = np.concatenate([col, np.full(n_rows, n_cols, np.int32)])
    j_idx, j_nnz = (np.asarray(x) for x in jx_sp.sort_compress_seps(
        jnp.asarray(row), jnp.asarray(col), n_rows, n_cols))
    t_idx, t_nnz = (x.numpy() for x in tp_sp.sort_compress_seps(
        torch.from_numpy(row), torch.from_numpy(col), n_rows, n_cols))
    assert int(t_nnz) == int(j_nnz)
    assert np.array_equal(t_idx[: int(t_nnz)], j_idx[: int(j_nnz)])
    if tp_sp.packable(n_rows, n_cols):
        key = (row << int(n_cols).bit_length()) | col
        k_idx, k_nnz = tp_sp.sort_compress_seps_keys(torch.from_numpy(key), n_rows, n_cols)
        jk_idx, jk_nnz = jx_sp.sort_compress_seps_keys(jnp.asarray(key), n_rows, n_cols)
        assert int(k_nnz) == int(jk_nnz) == int(t_nnz)
        assert np.array_equal(k_idx.numpy(), np.asarray(jk_idx))
    # the separator split gives sort_compress's CSR
    ptr, idx, real = tp_sp.split_seps(t_idx, int(t_nnz), n_rows, n_cols)
    r_ptr, r_idx, r_nnz = tp_sp.sort_compress(
        torch.from_numpy(row[:400]), torch.from_numpy(col[:400]), n_rows, n_cols)
    assert real == int(r_nnz)
    assert np.array_equal(ptr, r_ptr.numpy()) and np.array_equal(idx, r_idx[:real].numpy())


@pytest.mark.parametrize("m", [70, 1 << 26])
def test_esc_spgemm_matches_jax(m):
    a = with_empty_rows(jx.BCSR.random(45, 60, 3.0, seed=11), 4, 11)
    b = jx.BCSR.random(60, m, 3.0, seed=12)
    total = jx_sp.spgemm_flops(a, b)
    a_ptr, a_idx, a_nnz = padded(a, a.nnz + 8, 11)
    b_ptr = b.indptr.astype(np.int32)
    ja = (jnp.asarray(a_ptr), jnp.asarray(a_idx), jnp.asarray(a_nnz, jnp.int32),
          jnp.asarray(b_ptr), jnp.asarray(b.indices))
    ta = (torch.from_numpy(a_ptr), torch.from_numpy(a_idx), a_nnz,
          torch.from_numpy(b_ptr), torch.from_numpy(b.indices))
    kw = dict(n_cols=m, flops_pad=total + 13)
    j_ptr, j_idx, j_nnz = (np.asarray(x) for x in jx_sp.spgemm_padded(*ja, **kw))
    t_ptr, t_idx, t_nnz = (x.numpy() for x in tp_sp.esc_spgemm(*ta, **kw))
    assert int(t_nnz) == int(j_nnz) and np.array_equal(t_ptr, j_ptr)
    assert np.array_equal(t_idx[: int(t_nnz)], j_idx[: int(j_nnz)])
    c = tp.BCSR(t_ptr, t_idx[: int(t_nnz)], (45, m))
    assert c.equals(spgemm_oracle(to_port(a), to_port(b)))
    js_idx, js_nnz = (np.asarray(x) for x in jx_sp.spgemm_padded_seps(*ja, **kw))
    ts_idx, ts_nnz = (x.numpy() for x in tp_sp.esc_spgemm_seps(*ta, **kw))
    assert ts_idx.shape == (total + 13 + 45,) and int(ts_nnz) == int(js_nnz)
    assert np.array_equal(ts_idx[: int(ts_nnz)], js_idx[: int(js_nnz)])
    ptr, idx, real = tp_sp.split_seps(ts_idx, int(ts_nnz), 45, m)
    assert np.array_equal(ptr, t_ptr) and np.array_equal(idx, c.indices)


PLAN_CASES = [
    # (rows, rf high, chunk_flops, n_cols, force_pack)
    (5000, 10, 1 << 30, None, False),   # one chunk
    (5000, 10, 3000, 1000, False),      # many chunks, no row cap in play
    (5000, 10, 12_500, (1 << 20) - 1, False),  # the cap would add chunks: not taken
    (5000, 10, 12_500, (1 << 20) - 1, True),   # force_pack takes it
    (5000, 10, 12_500, (1 << 22), True),       # cap < 512: never taken
    (3000, 400, 2048, 200, False),     # rows past the budget alone
]


@pytest.mark.parametrize("n,hi,chunk_flops,n_cols,force_pack", PLAN_CASES)
def test_uniform_chunk_plan_matches_jax(n, hi, chunk_flops, n_cols, force_pack):
    ja = jx.BCSR.random(n, 50, 1.5, seed=n + hi)
    rf = np.random.default_rng(hi).integers(0, hi, n).astype(np.int64)
    rf[n // 3 : n // 3 + 40] = 0
    want = jx_sp.uniform_chunk_plan(ja, rf, chunk_flops, n_cols, force_pack=force_pack)
    got = tp_sp.uniform_chunk_plan(to_port(ja), rf, chunk_flops, n_cols,
                                   force_pack=force_pack)
    assert got == want
    chunks, rows_pad, nnz_pad, _ = got
    for r0, r1 in chunks:
        for x, y in zip(tp_sp.pad_chunk_csr(to_port(ja), r0, r1, rows_pad, nnz_pad, 3),
                        jx_sp.pad_chunk_csr(ja, r0, r1, rows_pad, nnz_pad, 3)):
            assert np.array_equal(x, y)


def test_force_pack_changes_the_plan():
    ja = jx.BCSR.random(5000, 50, 1.5, seed=5010)
    rf = np.random.default_rng(10).integers(0, 10, 5000).astype(np.int64)
    free = tp_sp.uniform_chunk_plan(to_port(ja), rf, 12_500, (1 << 20) - 1)
    packed = tp_sp.uniform_chunk_plan(to_port(ja), rf, 12_500, (1 << 20) - 1,
                                      force_pack=True)
    assert len(packed[0]) > len(free[0]) and max(r1 - r0 for r0, r1 in packed[0]) <= 1024


def test_uniform_chunk_plan_int32_row_raises():
    ja = jx.BCSR.random(10, 10, 1.0, seed=1)
    rf = np.zeros(10, np.int64)
    rf[4] = 1 << 31
    for mod, a in ((jx_sp, ja), (tp_sp, to_port(ja))):
        with pytest.raises(OverflowError, match="exceeds int32"):
            mod.uniform_chunk_plan(a, rf, 1 << 25, 10)
    rf[4] = (1 << 31) - 1  # the largest row that fits
    assert tp_sp.uniform_chunk_plan(to_port(ja), rf, 1 << 25, 10) == (
        jx_sp.uniform_chunk_plan(ja, rf, 1 << 25, 10))


EXECUTOR_CASES = [
    # (A rows, k, B cols, density, seed, chunk_flops)
    (300, 300, 300, 4.0, 1, None),       # one packed chunk
    (300, 300, 300, 4.0, 2, 900),        # many chunks
    (100, 500, 1 << 26, 3.0, 3, 700),    # two-key, many chunks
]


@pytest.mark.parametrize("n,k,m,d,seed,chunk_flops", EXECUTOR_CASES)
def test_spgemm_executor_matches_jax(n, k, m, d, seed, chunk_flops):
    ja = jx.BCSR.random(n, k, d, seed=seed)
    jb = jx.BCSR.random(k, m, d, seed=seed + 1)
    ta, tb = to_port(ja), to_port(jb)
    jex = jx_sp.SpGEMMExecutor(ja, jb, chunk_flops=chunk_flops)
    before = (dict(bitonic.sort_rows.routes), bitonic.bitonic_sort_rows.launches)
    tex = tp.SpGEMMExecutor(ta, tb, chunk_flops=chunk_flops, device="cpu")
    assert (tex.chunks, tex.flops_pad, tex._rows_pad) == (
        jex.chunks, jex.flops_pad, jex._rows_pad)
    assert (len(tex.chunks) > 1) == (chunk_flops is not None)
    for name in ("a_ptr", "a_idx", "a_nnz", "b_indptr", "b_indices"):
        got = getattr(tex, name)
        assert got.dtype == torch.int32 and got.device.type == "cpu", name
        assert np.array_equal(got.numpy(), np.asarray(getattr(jex, name))), name
    j_idx, j_nnz = (np.asarray(x) for x in jex.run())
    out = tex.run()
    t_idx, t_nnz = (x.numpy() for x in out)
    assert t_idx.shape == j_idx.shape and np.array_equal(t_nnz, j_nnz)
    for c in range(len(tex.chunks)):
        assert np.array_equal(t_idx[c, : t_nnz[c]], j_idx[c, : j_nnz[c]])
    c = tex.assemble(out)
    assert_same(jex.assemble(jex.run()), c)
    assert c.equals(spgemm_oracle(ta, tb))
    # ESC sorts with torch.sort and launches no hand kernel
    assert (dict(bitonic.sort_rows.routes), bitonic.bitonic_sort_rows.launches) == before


def test_spgemm_executor_int64_output(monkeypatch):
    """Past the int32 row-pointer domain the stitched indptr widens to int64
    (the domain lowered to 64 entries, as ``tests/test_int64_output.py``
    does)."""
    monkeypatch.setattr(jx_bcsr, "INDPTR_INT32_MAX", 64)
    monkeypatch.setattr(tp_bcsr, "INDPTR_INT32_MAX", 64)
    ja = jx.BCSR.random(200, 200, 3.0, seed=3)
    ta = to_port(ja)
    tex = tp.SpGEMMExecutor(ta, ta, chunk_flops=1 << 10, device="cpu")
    c = tex.assemble(tex.run())
    assert c.indptr.dtype == np.int64 and len(tex.chunks) > 1
    assert_same(jx.spgemm(ja, ja, chunk_flops=1 << 10), c)
    assert c.equals(spgemm_oracle(ta, ta))
    c1 = tp.spgemm(ta, ta, chunk_flops=1 << 10, device="cpu")
    assert c1.indptr.dtype == np.int64 and c1.equals(c)


def test_chunked_matches_unchunked():
    ja = jx.BCSR.random(500, 500, 6.0, seed=42)
    ta = to_port(ja)
    c_one = tp.spgemm(ta, ta, device="cpu")
    c_chunked = tp.spgemm(ta, ta, chunk_flops=1000, device="cpu")  # many chunks
    assert c_one.equals(c_chunked)
    assert c_one.equals(spgemm_oracle(ta, ta))
    assert_same(jx.spgemm(ja, ja, chunk_flops=1000), c_chunked)


def test_skewed_rows():
    rng = np.random.default_rng(0)
    rows = np.concatenate([np.zeros(500, int), rng.integers(0, 200, 300)])
    cols = rng.integers(0, 200, 800)
    ja = jx.BCSR.from_coo(rows, cols, (200, 200)).sum_duplicates()
    ta = to_port(ja)
    c = tp.spgemm(ta, ta, chunk_flops=2048, device="cpu")
    assert c.equals(spgemm_oracle(ta, ta))
    assert_same(jx.spgemm(ja, ja, chunk_flops=2048), c)


def test_spgemm_unpackable_key_domain():
    rng = np.random.default_rng(12)
    m = 1 << 26
    ja = jx.BCSR.from_coo(rng.integers(0, 100, 500), rng.integers(0, 500, 500), (100, 500))
    jb = jx.BCSR.from_coo(rng.integers(0, 500, 1500), rng.integers(0, m, 1500), (500, m))
    ta, tb = to_port(ja), to_port(jb)
    assert not tp_sp.packable(100, m)
    for chunk_flops in (None, 1 << 12):
        c = tp.spgemm(ta, tb, chunk_flops=chunk_flops, device="cpu")
        assert c.equals(spgemm_oracle(ta, tb))
        assert_same(jx.spgemm(ja, jb, chunk_flops=chunk_flops), c)


def test_one_shot_esc_is_pipelined(monkeypatch):
    """The one-shot ESC driver goes through ``_stitch_pipelined`` with chunk
    i+1 dispatched before chunk i is finished."""
    order = []
    real = tp_sp._stitch_pipelined

    def spy(chunks, rows_total, shape, dispatch, finish):
        def d(r0, r1):
            order.append(("dispatch", r0))
            return dispatch(r0, r1)

        def f(out):
            order.append(("finish",))
            return finish(out)

        return real(chunks, rows_total, shape, d, f)

    monkeypatch.setattr(tp_sp, "_stitch_pipelined", spy)
    ta = tp.BCSR.random(300, 300, 4.0, seed=6)
    c = tp.spgemm(ta, ta, chunk_flops=1500, device="cpu")
    assert c.equals(spgemm_oracle(ta, ta))
    kinds = [o[0] for o in order]
    n = kinds.count("dispatch")
    assert n > 2 and kinds[:3] == ["dispatch", "dispatch", "finish"]
    assert kinds[-2:] == ["finish", "finish"] and kinds.count("finish") == n


def test_stitch_pipelined_matches_stitch():
    a = tp.BCSR.random(300, 300, 3.0, seed=8)
    ref = tp.BCSR.from_scipy(a.to_scipy() @ a.to_scipy())
    chunks = [(0, 70), (70, 71), (71, 200), (200, 300)]

    def run_chunk(r0, r1):
        ptr = ref.indptr[r0 : r1 + 1] - ref.indptr[r0]
        idx = ref.indices[ref.indptr[r0] : ref.indptr[r1]]
        return ptr, np.concatenate([idx, [-1, -1]]), len(idx)

    def dispatch(r0, r1):
        ptr, idx, n = run_chunk(r0, r1)
        return torch.from_numpy(ptr), torch.from_numpy(idx), torch.tensor(n)

    def finish(out):
        return tuple(x.numpy() for x in out)

    got = tp_sp._stitch_pipelined(chunks, 300, ref.shape, dispatch, finish)
    want = tp_sp._stitch(chunks, 300, ref.shape, run_chunk)
    assert got.equals(ref)
    assert_same(want, got)
    assert_same(jx_sp._stitch(chunks, 300, ref.shape, run_chunk), got)


@pytest.mark.parametrize("total", [-3, 0, 1, 13, 16, 37, 40])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_pull_prefix_is_a_plain_slice(total, dtype):
    flat = torch.arange(40, dtype=dtype) * 3
    got = tp_sp.pull_prefix(flat, total)
    assert got.dtype == flat.numpy().dtype
    assert np.array_equal(got, flat.numpy()[: max(total, 0)])
    if total >= 0:
        assert np.array_equal(got, jx_sp.pull_prefix(jnp.asarray(flat.numpy()), total))


def test_constants_match_jax():
    assert tp_sp.DEFAULT_CHUNK_FLOPS == jx_sp.DEFAULT_CHUNK_FLOPS
    assert tp_sp.GIANT_ROW_FLOPS == jx_sp.GIANT_ROW_FLOPS
    assert tp_sp.COMPACT_PULL_BYTES == jx_sp.COMPACT_PULL_BYTES


def test_tuned_executor_matches_jax():
    """The same candidate bin counts as the JAX package (the model's best
    within the margin, plus the unrolled plan as k = 0), a winner that is
    the fastest of its report, bit-exact."""
    ja = jx.BCSR.random(6000, 6000, 2.0, seed=21)
    ta = to_port(ja)
    jex = jx_ell.tuned_executor(ja, ja, top=2, times=1)
    tex = tp.tuned_executor(ta, ta, top=2, times=1, device="cpu")
    assert isinstance(tex, tp.EllSpGEMMExecutor)
    assert sorted(k for _, k in tex.tune_report) == sorted(k for _, k in jex.tune_report)
    assert len(tex.tune_report) >= 2 and any(k == 0 for _, k in tex.tune_report)
    assert tex.tune_report == sorted(tex.tune_report)
    win_k = tex.tune_report[0][1]
    assert win_k == (tex.n_chunks if tex.batched else 0)
    c = tex.assemble(tex.run())
    assert c.equals(spgemm_oracle(ta, ta))
    assert_same(jex.assemble(jex.run()), c)
    ex2 = tp.EllSpGEMMExecutor(ta, ta, batched=True, device="cpu")
    assert ex2.k_ranking == sorted(ex2.k_ranking)


def test_tuned_executor_degenerate_and_masked():
    """A degenerate product gets the unrolled plan untuned; ``masked=True``
    tunes the masked plans (the JAX package's candidates) and returns an
    executor whose ``run_masked`` is bit-exact."""
    empty = tp.BCSR(np.zeros(101, np.int32), np.zeros(0, np.int32), (100, 100))
    ex = tp.tuned_executor(empty, empty, device="cpu")
    assert isinstance(ex, tp.EllSpGEMMExecutor) and not ex.batched
    assert not hasattr(ex, "tune_report")
    assert ex.assemble(ex.run()).nnz == 0
    ja, jf = jx.BCSR.random(6000, 6000, 2.0, seed=21), jx.BCSR.random(6000, 6000, 3.0, seed=22)
    ta, tf = to_port(ja), to_port(jf)
    jex = jx_ell.tuned_executor(ja, ja, masked=True, top=2, times=1)
    tex = tp.tuned_executor(ta, ta, masked=True, top=2, times=1, device="cpu")
    assert sorted(k for _, k in tex.tune_report) == sorted(k for _, k in jex.tune_report)
    c = tex.assemble(tex.run_masked(tf))
    assert c.equals(masked_spgemm_oracle(tf, ta, ta))
    assert_same(jex.assemble(jex.run_masked(jf)), c)


def test_tuned_executor_lets_faults_raise(monkeypatch):
    """Only an overflowing plan or a card out of memory skips a candidate;
    any other failure of a candidate's run raises."""
    a = tp.BCSR.random(3000, 3000, 2.0, seed=4)
    calls = []
    real_run = tp_ell.EllSpGEMMExecutor.run

    def failing(self):
        calls.append(self.batched)
        if self.batched:
            raise RuntimeError("kernel failed to launch")
        return real_run(self)

    monkeypatch.setattr(tp_ell.EllSpGEMMExecutor, "run", failing)
    with pytest.raises(RuntimeError, match="failed to launch"):
        tp.tuned_executor(a, a, top=2, times=1, device="cpu")

    def oom(self):
        if self.batched:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return real_run(self)

    monkeypatch.setattr(tp_ell.EllSpGEMMExecutor, "run", oom)
    ex = tp.tuned_executor(a, a, top=2, times=1, device="cpu")
    assert not ex.batched and [k for _, k in ex.tune_report] == [0]
    assert ex.assemble(real_run(ex)).equals(spgemm_oracle(a, a))


def test_auto_executor_chunk_flops_reaches_esc(monkeypatch):
    ja = jx.BCSR.random(3000, 3000, 4.0, seed=1)
    ta = to_port(ja)
    for mod in (tp_ell, jx_ell):
        monkeypatch.setattr(mod, "AUTO_ELL_MAX_SLOTS", 0)
    jex = jx_ell.auto_executor(ja, ja, chunk_flops=20_000)
    tex = tp.auto_executor(ta, ta, chunk_flops=20_000, device="cpu")
    assert isinstance(tex, tp.SpGEMMExecutor) and isinstance(jex, jx.SpGEMMExecutor)
    assert (tex.chunks, tex.flops_pad) == (jex.chunks, jex.flops_pad)
    assert len(tex.chunks) > 1
    c = tex.assemble(tex.run())
    assert_same(jex.assemble(jex.run()), c)
    assert c.equals(spgemm_oracle(ta, ta))


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 5 * 1024 + 3, (1 << 20) + 7])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_running_max_equals_cummax(n, dtype):
    """The row-parallel running maximum ESC scans with equals
    ``torch.cummax`` (one row, two levels and the recursive third)."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n)).to(dtype)
    x[::97] = torch.iinfo(dtype).min
    got = tp_sp._running_max(x)
    assert got.dtype == dtype and torch.equal(got, torch.cummax(x, 0).values)
    s = torch.sort(x).values  # already nondecreasing: itself
    assert torch.equal(tp_sp._running_max(s), s)


@pytest.mark.parametrize("shape", [(3, 0), (5, 320), (4, 1024), (3, 3000), (2, 5 * 1024 + 3)])
def test_running_max_along_the_last_axis(shape):
    """On a stack of rows, each row's running maximum (the staged side
    operands' owner scan)."""
    rng = np.random.default_rng(shape[1])
    x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, shape)).to(torch.int32)
    got = tp_sp._running_max(x)
    assert got.shape == x.shape and torch.equal(got, torch.cummax(x, -1).values)
