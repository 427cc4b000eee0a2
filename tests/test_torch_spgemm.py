"""The port's ``ops/spgemm.py`` subset against the JAX package's: the 2-D
sort-dedup-compact step (packed keys and the int64 pair form), the
separator split, the padding/packing rules, host flop counts, and the
compact-before-pull path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.ops import spgemm as jx_sp

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops import spgemm as tp_sp


def pair_stream(k, L, n_rows, n_cols, seed):
    """[k, L] candidate pairs with sentinel rows and one separator per
    chunk row (the shape of the batched engine's streams)."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n_rows + 1, (k, L)).astype(np.int32)
    col = np.where(row < n_rows, rng.integers(0, n_cols, (k, L)), n_cols)
    col = col.astype(np.int32)
    row[:, :n_rows] = np.arange(n_rows)
    col[:, :n_rows] = n_cols
    return row, col


def assert_same_compaction(j_out, t_out):
    j_idx, j_nnz = (np.asarray(x) for x in j_out)
    t_idx, t_nnz = (x.numpy() for x in t_out)
    assert t_idx.dtype == np.int32 and t_nnz.dtype == np.int32
    assert np.array_equal(j_nnz, t_nnz)
    for c in range(len(j_nnz)):
        assert np.array_equal(j_idx[c, : j_nnz[c]], t_idx[c, : t_nnz[c]])
    return t_idx, t_nnz


@pytest.mark.parametrize(
    "k,L,n_rows,n_cols,seed",
    [(6, 256, 40, 1000, 5), (3, 3968, 8, 65536, 2026), (9, 37, 4, 7, 1)],
)
def test_keys_form_matches_jax(k, L, n_rows, n_cols, seed):
    row, col = pair_stream(k, L, n_rows, n_cols, seed)
    shift = int(n_cols).bit_length()
    key = (row << shift) | col
    j_out = jx_sp.sort_compress_seps_2d_keys(jnp.asarray(key), n_rows, n_cols)
    t_out = tp_sp.sort_compress_seps_2d_keys(torch.from_numpy(key), n_rows, n_cols)
    idx, nnz = assert_same_compaction(j_out, t_out)
    for c in range(k):  # split_seps agrees on every chunk
        j = jx_sp.split_seps(np.asarray(j_out[0])[c], int(nnz[c]), n_rows, n_cols)
        t = tp_sp.split_seps(idx[c], int(nnz[c]), n_rows, n_cols)
        assert all(np.array_equal(x, y) for x, y in zip(j, t))


def test_pair_form_unpackable_matches_jax():
    n_rows, n_cols = 5000, 1 << 20
    assert not tp_sp.packable(n_rows, n_cols)
    row, col = pair_stream(4, 6000, n_rows, n_cols, 8)
    j_out = jx_sp.sort_compress_seps_2d(
        jnp.asarray(row), jnp.asarray(col), n_rows, n_cols
    )
    t_out = tp_sp.sort_compress_seps_2d(
        torch.from_numpy(row), torch.from_numpy(col), n_rows, n_cols
    )
    assert_same_compaction(j_out, t_out)


def test_pair_form_equals_keys_form(monkeypatch):
    # the int64 pair branch and the packed branch are two implementations of
    # one contract: forced onto the pair branch, the results must agree
    n_rows, n_cols = 40, 1000
    row, col = pair_stream(6, 256, n_rows, n_cols, 5)
    key = (row << int(n_cols).bit_length()) | col
    want = tp_sp.sort_compress_seps_2d_keys(torch.from_numpy(key), n_rows, n_cols)
    monkeypatch.setattr(tp_sp, "packable", lambda *a: False)
    got = tp_sp.sort_compress_seps_2d(
        torch.from_numpy(row), torch.from_numpy(col), n_rows, n_cols
    )
    assert torch.equal(got[1], want[1])
    for c in range(6):
        n = int(want[1][c])
        assert torch.equal(got[0][c, :n], want[0][c, :n])


def test_stitch_matches_jax():
    # contiguous row chunks of one product, each split from its separator
    # stream, stitched back into one CSR
    a = tp.BCSR.random(300, 300, 3.0, seed=8)
    ref = tp.BCSR.from_scipy(a.to_scipy() @ a.to_scipy())
    chunks = [(0, 70), (70, 71), (71, 200), (200, 300)]

    def run_chunk(r0, r1):
        ptr = ref.indptr[r0 : r1 + 1] - ref.indptr[r0]
        idx = ref.indices[ref.indptr[r0] : ref.indptr[r1]]
        return ptr, np.concatenate([idx, [-1, -1]]), len(idx)  # padded tail

    got = tp_sp._stitch(chunks, 300, ref.shape, run_chunk)
    want = jx_sp._stitch(chunks, 300, ref.shape, run_chunk)
    assert got.equals(ref)
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)


def test_split_seps_rejects_a_broken_stream():
    with pytest.raises(RuntimeError, match="separator-count"):
        tp_sp.split_seps(np.array([1, 2, 3], np.int32), 3, 2, 9)


def test_pad_bucket_and_packable_match_jax():
    for n in list(range(0, 300)) + [1000, 3968, 4097, 65537, (1 << 27) + 1]:
        for minimum, div in ((8, 16), (1, 32), (8, 32)):
            assert tp_sp.pad_bucket(n, minimum, div) == jx_sp.pad_bucket(
                n, minimum, div
            )
    for n_rows in (1, 7, 8, 2047, 8191, 1 << 14):
        for n_cols in (1, 1000, 65536, 262145, 1 << 20):
            assert tp_sp.packable(n_rows, n_cols) == jx_sp.packable(n_rows, n_cols)


@pytest.mark.parametrize("seed", [1, 2])
def test_row_flops_match_jax(seed):
    ja = jx.BCSR.random(3000, 1500, 3.0, seed=seed)
    jb = jx.BCSR.random(1500, 2500, 2.0, seed=seed + 10)
    ta = tp.bcsr_from_arrays(ja.indptr, ja.indices, ja.shape)
    tb = tp.bcsr_from_arrays(jb.indptr, jb.indices, jb.shape)
    assert np.array_equal(jx_sp.row_flops(ja, jb), tp_sp.row_flops(ta, tb))
    assert jx_sp.spgemm_flops(ja, jb) == tp.spgemm_flops(ta, tb)
    tp_sp.require_int32_operands(ta, tb)  # int32-sized operands pass


def padded_stack(C, Pp, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << 20, (C, Pp)).astype(np.int32)
    nnz = rng.integers(0, Pp + 1, C).astype(np.int32)
    nnz[1] = 0  # an empty chunk
    return idx, nnz


def test_compact_chunks_matches_jax():
    idx, nnz = padded_stack(7, 50, 3)
    total = int(nnz.sum())
    j = np.asarray(jx_sp.compact_chunks(jnp.asarray(idx), jnp.asarray(nnz)))
    t = tp_sp.compact_chunks(torch.from_numpy(idx), torch.from_numpy(nnz)).numpy()
    assert t.dtype == np.int32
    assert np.array_equal(t[:total], j[:total])
    assert np.array_equal(
        t[:total], np.concatenate([idx[c, : nnz[c]] for c in range(7)])
    )


def test_compact_pull_gives_the_straight_pull(monkeypatch):
    idx, nnz = padded_stack(9, 64, 4)
    valid = nnz.astype(np.int64)
    straight = tp_sp.pull_chunk_prefixes(torch.from_numpy(idx), valid)
    assert tp_sp.compact_pull(torch.from_numpy(idx), valid) is None  # under the gate
    for C, Pp, total in ((9, 64, int(valid.sum())), (64, 1 << 20, 1 << 20),
                         (64, 1 << 20, 63 << 20)):
        assert tp_sp.should_compact_pull(C, Pp, 4, total) == (
            jx_sp.should_compact_pull(C, Pp, 4, total)
        )
    monkeypatch.setattr(tp_sp, "COMPACT_PULL_BYTES", 0)
    compacted = tp_sp.compact_pull(torch.from_numpy(idx), valid)
    assert compacted is not None
    # the group-wise path for stacks past the single-block budget
    monkeypatch.setattr(tp_sp, "_COMPACT_BLOCK_BYTES", 0)
    monkeypatch.setattr(tp_sp, "_COMPACT_GROUP_BYTES", 3 * 64 * 4)
    grouped = tp_sp.compact_pull(torch.from_numpy(idx), valid)
    for parts in (compacted, grouped):
        assert len(parts) == len(straight)
        assert all(np.array_equal(x, y) for x, y in zip(parts, straight))
