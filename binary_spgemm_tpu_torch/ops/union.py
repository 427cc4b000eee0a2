"""Row-wise sparse boolean union: C = A OR B.

Counterpart of ``binary_spgemm_tpu/ops/union.py``.  The union is the
compress step of the ESC engine applied to the concatenation of both
operands' (row, col) pairs: one sort and an adjacent-duplicate drop
(:func:`..spgemm.sort_compress`).  Small unions run on the host
(:func:`..host.host_spm_or`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats.bcsr import BCSR
from .spgemm import (
    INT,
    _row_ids,
    _upload,
    pad_bucket,
    pull_padded_tuple,
    require_int32_operands,
    resolve_device,
    sort_compress,
)

__all__ = ["spm_or", "spm_or_padded"]


def spm_or_padded(
    a_indptr: torch.Tensor,
    a_indices: torch.Tensor,
    a_nnz,
    b_indptr: torch.Tensor,
    b_indices: torch.Tensor,
    b_nnz,
    *,
    n_cols: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Union over padded CSR tensors of one shape.  Returns ``(c_indptr,
    c_indices padded [len(a_indices) + len(b_indices)], nnz_c)``."""
    n_rows = a_indptr.shape[0] - 1

    def pairs(indptr, indices, nnz):
        pad = indices.shape[0]
        rows = _row_ids(indptr, pad)
        valid = torch.arange(pad, dtype=INT, device=indices.device) < nnz
        return torch.where(valid, rows, n_rows), torch.where(valid, indices, n_cols)

    ra, ca = pairs(a_indptr, a_indices, a_nnz)
    rb, cb = pairs(b_indptr, b_indices, b_nnz)
    return sort_compress(torch.cat([ra, rb]), torch.cat([ca, cb]), n_rows, n_cols)


def spm_or(a: BCSR, b: BCSR, *, device: str | torch.device = "cuda") -> BCSR:
    """C = A OR B structure (≡ ``SpM_OR``), canonical output.  Unions of at
    most ``HOST_OR_MAX_NNZ`` combined entries run on the host; the rest on
    ``device``."""
    if tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    require_int32_operands(a, b)
    n, m = a.shape
    from .host import HOST_OR_MAX_NNZ, host_spm_or

    if a.nnz + b.nnz <= HOST_OR_MAX_NNZ:
        return host_spm_or(a, b)
    device = resolve_device(device)

    def padded(mat):
        idx = np.zeros(pad_bucket(mat.nnz), np.int32)
        idx[: mat.nnz] = mat.indices
        return (_upload(mat.indptr.astype(np.int32), device), _upload(idx, device),
                mat.nnz)

    out = spm_or_padded(*padded(a), *padded(b), n_cols=m)
    ptr, idx, _ = pull_padded_tuple(*out)
    return BCSR(ptr, idx, (n, m))
