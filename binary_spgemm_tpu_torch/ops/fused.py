"""Fused boolean products: C = D OR (A·B), optionally masked.

Counterpart of ``binary_spgemm_tpu/ops/fused.py`` (the reference's
``SpGEMM_dor`` family).  D's (row, col) pairs join the candidate stream
before the sort, so the union costs one slightly longer sort.  With a mask F
the join is three-way: mask, D and candidate entries share the stream with a
2-bit tag ordering them mask < D < candidate within an equal (row, col) run;
a D entry survives as its run's first D, a candidate only when its left
neighbour is its pair's mask entry.

Masked semantics, as in the JAX package and deliberately unlike the
reference's ``SpGEMM_dor_masked`` (which computes ``F ∩ (D ∪ A·B)``): D is
unconditional, ``C = D ∪ (F ∩ A·B)``, so accumulation into D is monotone.
To get the reference's contract, intersect D with F before the call.
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats.bcsr import BCSR
from .spgemm import (
    DEFAULT_CHUNK_FLOPS,
    INT,
    INT32_MAX,
    _compact_pairs,
    _indptr,
    _prev,
    _row_ids,
    _shr_logical,
    _sort_keys,
    _sort_tagged,
    _stitch_pipelined,
    _upload,
    expand_pairs,
    pad_bucket,
    pad_chunk_csr,
    packable,
    pull_padded_tuple,
    require_int32_operands,
    resolve_device,
    row_flops,
    sort_compress,
    spgemm_flops,
    uniform_chunk_plan,
)

__all__ = ["spgemm_or", "spgemm_or_padded"]


def _or_masked_compress(row, col, d_row, d_col, f_row, f_col, n_rows: int,
                        n_cols: int, *, seps: bool, key=None):
    """The three-way tagged join along the last axis (mask tag 0 < D tag 1 <
    candidate tag 2).  With ``seps`` the candidate-tagged ``(r, n_cols)``
    separators survive unconditionally.  D and mask pairs are
    sentinel-masked already.

    Where ``packable(n_rows, 4 * n_cols + 3)`` the join key is the int32
    ``(plain key << 2) | 2`` for candidates (``key`` the plain packed keys,
    else built from the pairs) and ``(row << bl + 2) | (col << 2) | tag`` for
    D and mask; the pair field is read with a logical shift, as the JAX
    package reads it (the left neighbour of slot 0 is -1).  Otherwise the
    three-key sort of :func:`..spgemm._sort_tagged`.  Returns ``(columns,
    row ids, nnz)`` of the compacted stream."""
    if packable(n_rows, 4 * n_cols + 3):
        bl = int(n_cols).bit_length()
        shift, col_mask = bl + 2, (1 << bl) - 1
        if key is None:
            key = (row << bl) | col
        key_s = _sort_keys(torch.cat([
            (key << 2) | 2,  # candidates last in a run
            (d_row << shift) | (d_col << 2) | 1,
            (f_row << shift) | (f_col << 2),  # mask first in a run
        ], dim=-1))
        prev = _prev(key_s, -1)
        tag, prev_tag = key_s & 3, prev & 3
        same = _shr_logical(key_s, 2) == _shr_logical(prev, 2)
        bound = key_s < ((n_rows << shift) | 2)
        keep = (((tag == 1) & (~same | (prev_tag == 0)))
                | ((tag == 2) & same & (prev_tag == 0))) & bound
        if seps:
            keep |= (tag == 2) & bound & (((key_s >> 2) & col_mask) == n_cols)
        nnz_c = keep.sum(-1, dtype=INT)
        c_keys = _sort_keys(torch.where(keep, key_s, INT32_MAX))
        return (c_keys >> 2) & col_mask, _shr_logical(c_keys, shift), nnz_c
    row_s, col_s, tag_s = _sort_tagged(
        [(row, col, 2), (d_row, d_col, 1), (f_row, f_col, 0)], n_rows, n_cols, 2)
    same = (row_s == _prev(row_s, -1)) & (col_s == _prev(col_s, -1))
    prev_tag = _prev(tag_s, 2)
    in_range = row_s < n_rows
    keep = (((tag_s == 1) & (~same | (prev_tag == 0)))
            | ((tag_s == 2) & same & (prev_tag == 0))) & in_range
    if seps:
        keep |= (tag_s == 2) & (col_s == n_cols) & in_range
    return _compact_pairs(keep, row_s, col_s, n_rows, n_cols)


def _sort_compress_or_masked(row, col, d_row, d_col, f_row, f_col, n_rows: int,
                             n_cols: int):
    """C = D OR (F .* candidates) over one stream or a stack of streams
    (along the last axis).  Returns ``(c_indptr [..., n_rows + 1], c_indices,
    nnz_c)``."""
    cols, rows, nnz_c = _or_masked_compress(row, col, d_row, d_col, f_row, f_col,
                                            n_rows, n_cols, seps=False)
    return _indptr(rows, n_rows), cols, nnz_c


def _sort_compress_or_masked_seps_2d(row, col, d_row, d_col, f_row, f_col,
                                     n_rows: int, n_cols: int):
    """Batched :func:`_sort_compress_or_masked` with embedded row separators
    (one ``(r, n_cols)`` candidate per chunk row, never a real column).
    Returns separator-embedded ``(indices, nnz)`` stacked over chunks."""
    cols, _, nnz_c = _or_masked_compress(row, col, d_row, d_col, f_row, f_col,
                                         n_rows, n_cols, seps=True)
    return cols, nnz_c


def _sort_compress_or_masked_seps_2d_keys(key, d_row, d_col, f_row, f_col,
                                          n_rows: int, n_cols: int):
    """:func:`_sort_compress_or_masked_seps_2d` on the pre-packed plain key
    stream (the caller checks ``packable(n_rows, 4 * n_cols + 3)``)."""
    cols, _, nnz_c = _or_masked_compress(None, None, d_row, d_col, f_row, f_col,
                                         n_rows, n_cols, seps=True, key=key)
    return cols, nnz_c


def _padded_pairs(indptr, indices, nnz, n_rows: int, n_cols: int):
    """Sentinel-masked ``(row, col)`` pairs of a padded CSR operand."""
    pad = indices.shape[0]
    valid = torch.arange(pad, dtype=INT, device=indices.device) < nnz
    return (torch.where(valid, _row_ids(indptr, pad), n_rows),
            torch.where(valid, indices, n_cols))


def spgemm_or_padded(
    d_indptr, d_indices, d_nnz, a_indptr, a_indices, a_nnz, b_indptr, b_indices,
    f_indptr=None, f_indices=None, *, n_cols: int, flops_pad: int,
    check_total: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """C = D OR ((F .*)? (A·B)) over padded CSR tensors.  Unmasked, D's
    pairs join the candidate stream before :func:`..spgemm.sort_compress`;
    masked, the three-way tagged join.  Returns ``(c_indptr, c_indices
    padded, nnz_c)``."""
    n_rows = a_indptr.shape[0] - 1
    row, col = expand_pairs(
        a_indptr, a_indices, a_nnz, b_indptr, b_indices,
        n_cols=n_cols, flops_pad=flops_pad, check_total=check_total,
    )
    d_rows, d_cols = _padded_pairs(d_indptr, d_indices, d_nnz, n_rows, n_cols)
    if f_indptr is None:
        return sort_compress(torch.cat([row, d_rows]), torch.cat([col, d_cols]),
                             n_rows, n_cols)
    f_rows, f_cols = _padded_pairs(f_indptr, f_indices, f_indptr[-1], n_rows, n_cols)
    return _sort_compress_or_masked(row, col, d_rows, d_cols, f_rows, f_cols,
                                    n_rows, n_cols)


def spgemm_or(
    d: BCSR,
    a: BCSR,
    b: BCSR,
    *,
    mask: BCSR | None = None,
    chunk_flops: int | None = None,
    device: str | torch.device = "cuda",
) -> BCSR:
    """C = D OR (A·B), or D OR (mask .* (A·B)) (≡ ``SpGEMM_dor``; D is
    unconditional under a mask, see the module docstring).  Routes as the
    JAX package's does: small products to the host, the sliced-ELL executor
    (``run_or``) while what it allocates fits ``AUTO_ELL_MAX_SLOTS``, the
    chunked ESC engine past that or for an explicit ``chunk_flops``."""
    if a.n_cols != b.n_rows or tuple(d.shape) != (a.n_rows, b.n_cols):
        raise ValueError(f"shape mismatch: D{d.shape} vs {a.shape} @ {b.shape}")
    require_int32_operands(d, a, b)
    n, m = a.n_rows, b.n_cols
    if a.nnz == 0 or b.nnz == 0:
        from .union import spm_or

        empty = BCSR(np.zeros(n + 1, np.int32), np.zeros(0, np.int32), (n, m))
        return spm_or(d, empty, device=device)
    if mask is not None:
        if tuple(mask.shape) != (n, m):
            raise ValueError(f"mask shape {mask.shape} != {(n, m)}")
        mask = mask.sum_duplicates()

    from .host import HOST_OR_MAX_NNZ, host_spgemm_or

    mask_nnz = mask.nnz if mask is not None else 0
    if (
        chunk_flops is None
        and d.nnz + mask_nnz <= HOST_OR_MAX_NNZ  # O(1) screen first
        and spgemm_flops(a, b) + d.nnz + mask_nnz <= HOST_OR_MAX_NNZ
    ):
        return host_spgemm_or(d, a, b, mask=mask)

    if chunk_flops is None:
        from .ell import AUTO_ELL_MAX_SLOTS, cached_executor

        try:
            ex = cached_executor(a, b, masked=mask is not None, device=device)
            # budget what run_or allocates: every chunk's sort and output
            # widen by the staged D (and mask) pads
            d_pad = ex.staged_nnz_pad(d)
            if mask is None:
                budget = min(
                    pad_bucket(ex.out_pad + d_pad),
                    pad_bucket(ex.sort_pad + d_pad, div=32),
                ) * ex.n_chunks
            else:
                # the batched join keeps the separator-embedded stream; the
                # unrolled one sorts without the separators
                base = ex.sort_pad if ex.batched else ex.sort_pad - ex.rows_pad
                budget = (base + d_pad + ex.staged_nnz_pad(mask)) * ex.n_chunks
            if budget <= AUTO_ELL_MAX_SLOTS:
                return ex.assemble(ex.run_or(d, mask=mask))
        except OverflowError:
            pass

    device = resolve_device(device)
    rf = row_flops(a, b)
    # the masked join packs (row, col, 2-bit tag): the row cap of that key
    key_cols = (4 * m + 3) if mask is not None else m
    chunks, rows_pad, nnz_pad, flops_pad = uniform_chunk_plan(
        a, rf, chunk_flops or DEFAULT_CHUNK_FLOPS, key_cols
    )

    def side_pad(mat):
        return pad_bucket(max(int(mat.indptr[r1] - mat.indptr[r0])
                              for r0, r1 in chunks))

    d_nnz_pad = side_pad(d)
    f_nnz_pad = side_pad(mask) if mask is not None else None
    b_indptr = _upload(b.indptr.astype(np.int32), device)
    b_indices = _upload(b.indices.astype(np.int32), device)

    def dispatch(r0, r1):
        ptr, idx, nnz_local = pad_chunk_csr(a, r0, r1, rows_pad, nnz_pad)
        d_ptr, d_idx, d_local = pad_chunk_csr(d, r0, r1, rows_pad, d_nnz_pad)
        args = [_upload(d_ptr, device), _upload(d_idx, device), d_local,
                _upload(ptr, device), _upload(idx, device), nnz_local,
                b_indptr, b_indices]
        if mask is not None:
            f_ptr, f_idx, _ = pad_chunk_csr(mask, r0, r1, rows_pad, f_nnz_pad, fill=m)
            args += [_upload(f_ptr, device), _upload(f_idx, device)]
        return spgemm_or_padded(*args, n_cols=m, flops_pad=flops_pad,
                                check_total=False)

    return _stitch_pipelined(chunks, n, (n, m), dispatch,
                             lambda out: pull_padded_tuple(*out))
