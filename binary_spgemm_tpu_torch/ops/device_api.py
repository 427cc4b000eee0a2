"""Device-resident op entry points over :class:`..spgemm.DeviceBCSR`.

Counterpart of ``binary_spgemm_tpu/ops/device_api.py``.  For pipelines that
keep matrices on the card across many ops (iterated products, reachability
closures, benchmark loops), these avoid the host round trips of the one-shot
API: inputs and outputs are ``DeviceBCSR`` with padded index arrays and 0-d
``nnz`` tensors.

The output's ``indices`` array is padded to the product's ``flops_pad`` —
call :meth:`..spgemm.DeviceBCSR.compact` (one host sync) or feed it onward.
No op reads a value back to the host, with one exception: each expansion
reads its candidate count once and raises ``ValueError`` when
``flops_pad`` is below it, where the JAX package drops the candidates past
``flops_pad`` without a signal (:func:`..spgemm.expand_pairs`).
"""
from __future__ import annotations

import torch

from .counts import masked_counts_compress, masked_counts_sum, sort_compress_counts
from .fused import spgemm_or_padded
from .masked import masked_spgemm_padded
from .spgemm import INT, DeviceBCSR, esc_spgemm, expand_pairs
from .union import spm_or_padded

__all__ = [
    "counts_sum_device",
    "flops_bound_device",
    "masked_spgemm_counts_device",
    "masked_spgemm_device",
    "spgemm_counts_device",
    "spgemm_device",
    "spgemm_or_device",
    "spm_or_device",
]


def _row_lengths(a: DeviceBCSR, b: DeviceBCSR) -> torch.Tensor:
    """The length of B's row at each slot of A's padded index array (0 at
    and past ``a.nnz``): the flops each entry of A expands to."""
    valid = torch.arange(a.indices.shape[0], dtype=INT, device=a.indices.device) < a.nnz
    acol = torch.where(valid, a.indices, 0)
    blen = (torch.index_select(b.indptr, 0, acol + 1)
            - torch.index_select(b.indptr, 0, acol))
    return torch.where(valid, blen, 0)


def flops_bound_device(a: DeviceBCSR, b: DeviceBCSR) -> torch.Tensor:
    """Gustavson flop count of a·b as a 0-d int32 tensor (no host sync).
    int32 like the whole index domain: it must stay below 2^31."""
    return _row_lengths(a, b).sum(dtype=INT)


def _check_product(a: DeviceBCSR, b: DeviceBCSR) -> None:
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")


def _check_masked(f: DeviceBCSR, a: DeviceBCSR, b: DeviceBCSR) -> None:
    if a.shape[1] != b.shape[0] or tuple(f.shape) != (a.shape[0], b.shape[1]):
        raise ValueError(f"shape mismatch: F{f.shape} vs {a.shape} @ {b.shape}")


def _expand(a: DeviceBCSR, b: DeviceBCSR, flops_pad: int):
    return expand_pairs(a.indptr, a.indices, a.nnz, b.indptr, b.indices,
                        n_cols=b.shape[1], flops_pad=flops_pad)


def spgemm_device(a: DeviceBCSR, b: DeviceBCSR, *, flops_pad: int) -> DeviceBCSR:
    """C = A·B structure on the device.  ``flops_pad`` must bound the
    Gustavson flop count (from :func:`flops_bound_device` or an analytic
    bound); the output is padded to it."""
    _check_product(a, b)
    c_ptr, c_idx, nnz_c = esc_spgemm(
        a.indptr, a.indices, a.nnz, b.indptr, b.indices,
        n_cols=b.shape[1], flops_pad=flops_pad,
    )
    return DeviceBCSR(c_ptr, c_idx, nnz_c, (a.shape[0], b.shape[1]))


def spm_or_device(a: DeviceBCSR, b: DeviceBCSR) -> DeviceBCSR:
    """C = A OR B on the device."""
    if tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    c_ptr, c_idx, nnz_c = spm_or_padded(
        a.indptr, a.indices, a.nnz, b.indptr, b.indices, b.nnz, n_cols=a.shape[1],
    )
    return DeviceBCSR(c_ptr, c_idx, nnz_c, tuple(a.shape))


def spgemm_or_device(
    d: DeviceBCSR,
    a: DeviceBCSR,
    b: DeviceBCSR,
    *,
    flops_pad: int,
    mask: DeviceBCSR | None = None,
) -> DeviceBCSR:
    """C = D OR (A·B), or with ``mask`` D OR (mask .* (A·B)), on the device
    in one sort: the accumulate step of resident iterated products.  D is
    unconditional; ``mask`` must be canonical like every mask operand."""
    if a.shape[1] != b.shape[0] or tuple(d.shape) != (a.shape[0], b.shape[1]):
        raise ValueError(f"shape mismatch: D{d.shape} vs {a.shape} @ {b.shape}")
    args = [d.indptr, d.indices, d.nnz, a.indptr, a.indices, a.nnz,
            b.indptr, b.indices]
    if mask is not None:
        if tuple(mask.shape) != tuple(d.shape):
            raise ValueError(f"mask shape {mask.shape} != {d.shape}")
        args += [mask.indptr, mask.indices]
    c_ptr, c_idx, nnz_c = spgemm_or_padded(*args, n_cols=b.shape[1],
                                           flops_pad=flops_pad)
    return DeviceBCSR(c_ptr, c_idx, nnz_c, tuple(d.shape))


def masked_spgemm_device(
    f: DeviceBCSR, a: DeviceBCSR, b: DeviceBCSR, *, flops_pad: int
) -> DeviceBCSR:
    """C = F .* (A·B) on the device (mask FIRST).  ``f`` must be canonical."""
    _check_masked(f, a, b)
    c_ptr, c_idx, nnz_c = masked_spgemm_padded(
        f.indptr, f.indices, a.indptr, a.indices, a.nnz, b.indptr, b.indices,
        n_cols=b.shape[1], flops_pad=flops_pad,
    )
    return DeviceBCSR(c_ptr, c_idx, nnz_c, tuple(f.shape))


def spgemm_counts_device(
    a: DeviceBCSR, b: DeviceBCSR, *, flops_pad: int
) -> tuple[DeviceBCSR, torch.Tensor]:
    """C = A·B structure and each entry's multiplicity on the device:
    ``(c, counts)`` with ``counts`` (int32) padded like ``c.indices``.  The
    operands must be canonical (stage them with
    ``DeviceBCSR.from_host(mat, require_canonical=True)``): duplicate
    entries would inflate the multiplicities."""
    _check_product(a, b)
    row, col = _expand(a, b, flops_pad)
    c_ptr, c_idx, c_cnt, nnz_c = sort_compress_counts(row, col, a.shape[0], b.shape[1])
    return DeviceBCSR(c_ptr, c_idx, nnz_c, (a.shape[0], b.shape[1])), c_cnt


def masked_spgemm_counts_device(
    f: DeviceBCSR, a: DeviceBCSR, b: DeviceBCSR, *, flops_pad: int
) -> tuple[DeviceBCSR, torch.Tensor]:
    """C = F .* (A·B) structure and multiplicities on the device (mask
    FIRST).  ``f`` and the operands must be canonical."""
    _check_masked(f, a, b)
    row, col = _expand(a, b, flops_pad)
    c_ptr, c_idx, c_cnt, nnz_c = masked_counts_compress(
        row, col, f.indptr, f.indices, f.nnz, a.shape[0], b.shape[1])
    return DeviceBCSR(c_ptr, c_idx, nnz_c, tuple(f.shape)), c_cnt


def counts_sum_device(
    f: DeviceBCSR, a: DeviceBCSR, b: DeviceBCSR, *, flops_pad: int
) -> torch.Tensor:
    """The sum over the mask entries (i, j) of the multiplicity of (A·B)[i,
    j], a 0-d int32 tensor.  With f = a = b a symmetric hollow adjacency
    this is 6 times the triangle count."""
    _check_masked(f, a, b)
    row, col = _expand(a, b, flops_pad)
    return masked_counts_sum(row, col, f.indptr, f.indices, f.nnz,
                             a.shape[0], b.shape[1])
