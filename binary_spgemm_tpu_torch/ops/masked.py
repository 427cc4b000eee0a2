"""Masked boolean SpGEMM: C = F .* (A·B).

Counterpart of ``binary_spgemm_tpu/ops/masked.py`` (the reference's
``SpGEMM_masked``).  The mask test is fused into the sort
(:func:`..spgemm.sort_compress_masked`): F's pairs join the candidate stream
with a tag bit that orders them first within an equal (row, col) run, so a
candidate survives iff its sorted left neighbour is its own pair's mask
entry.  One slightly longer sort replaces per-candidate probes of F.

:func:`masked_spgemm` routes as the JAX package's does: small products to the
host engine, products whose masked sliced-ELL plan fits
``AUTO_ELL_MAX_SLOTS`` to ``cached_executor(masked=True).run_masked``, and the
rest (or an explicit ``chunk_flops``) through the chunked ESC engine.
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats.bcsr import BCSR
from .spgemm import (
    DEFAULT_CHUNK_FLOPS,
    _row_ids,
    _stitch_pipelined,
    _upload,
    expand_pairs,
    pad_bucket,
    pad_chunk_csr,
    pull_padded_tuple,
    require_int32_operands,
    resolve_device,
    row_flops,
    sort_compress_masked,
    spgemm_flops,
    uniform_chunk_plan,
)

__all__ = ["masked_spgemm", "masked_spgemm_padded"]


def masked_spgemm_padded(
    f_indptr: torch.Tensor,
    f_indices: torch.Tensor,
    a_indptr: torch.Tensor,
    a_indices: torch.Tensor,
    a_nnz,
    b_indptr: torch.Tensor,
    b_indices: torch.Tensor,
    *,
    n_cols: int,
    flops_pad: int,
    check_total: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked ESC SpGEMM over padded CSR tensors: :func:`..spgemm.esc_spgemm`'s
    contract plus the mask F (``f_indices`` padded, its slots past
    ``f_indptr[-1]`` ignored)."""
    n_rows = a_indptr.shape[0] - 1
    row, col = expand_pairs(
        a_indptr, a_indices, a_nnz, b_indptr, b_indices,
        n_cols=n_cols, flops_pad=flops_pad, check_total=check_total,
    )
    f_rows = _row_ids(f_indptr, f_indices.shape[0])
    return sort_compress_masked(row, col, f_rows, f_indices, f_indptr[-1],
                                n_rows, n_cols)


def masked_spgemm(
    f: BCSR,
    a: BCSR,
    b: BCSR,
    *,
    chunk_flops: int | None = None,
    device: str | torch.device = "cuda",
) -> BCSR:
    """C = F .* (A·B) structure (≡ ``SpGEMM_masked``; mask first).  F is
    canonicalised on the host first."""
    if a.n_cols != b.n_rows or tuple(f.shape) != (a.n_rows, b.n_cols):
        raise ValueError(f"shape mismatch: F{f.shape} vs {a.shape} @ {b.shape}")
    require_int32_operands(f, a, b)
    n, m = a.n_rows, b.n_cols
    if a.nnz == 0 or b.nnz == 0 or f.nnz == 0:
        return BCSR(np.zeros(n + 1, np.int32), np.zeros(0, np.int32), (n, m))
    f = f.sum_duplicates()

    if chunk_flops is None:
        from .host import HOST_MAX_FLOPS, host_masked_spgemm

        if spgemm_flops(a, b) <= HOST_MAX_FLOPS:
            return host_masked_spgemm(f, a, b)
        from .ell import AUTO_ELL_MAX_SLOTS, cached_executor

        # masked=True halves the chunk row cap so the (row, col, tag) key
        # stays one packed int32
        try:
            ex = cached_executor(a, b, masked=True, device=device)
            if ex.total_slots <= AUTO_ELL_MAX_SLOTS:
                return ex.assemble(ex.run_masked(f))
        except OverflowError:
            pass

    device = resolve_device(device)
    rf = row_flops(a, b)
    # the join packs (row, col, tag bit): the row cap is that of the wider key
    chunks, rows_pad, nnz_pad, flops_pad = uniform_chunk_plan(
        a, rf, chunk_flops or DEFAULT_CHUNK_FLOPS, 2 * m + 1
    )
    # F sliced to the same rows, padded to one size across chunks
    f_nnz_pad = pad_bucket(
        max(int(f.indptr[r1] - f.indptr[r0]) for r0, r1 in chunks)
    )
    b_indptr = _upload(b.indptr.astype(np.int32), device)
    b_indices = _upload(b.indices.astype(np.int32), device)

    def dispatch(r0, r1):
        ptr, idx, nnz_local = pad_chunk_csr(a, r0, r1, rows_pad, nnz_pad)
        f_ptr, f_idx, _ = pad_chunk_csr(f, r0, r1, rows_pad, f_nnz_pad, fill=m)
        return masked_spgemm_padded(
            _upload(f_ptr, device), _upload(f_idx, device), _upload(ptr, device),
            _upload(idx, device), nnz_local, b_indptr, b_indices,
            n_cols=m, flops_pad=flops_pad, check_total=False,
        )

    return _stitch_pipelined(chunks, n, (n, m), dispatch,
                             lambda out: pull_padded_tuple(*out))
