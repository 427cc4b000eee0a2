"""The plain reference: boolean C = A·A and the triangle count, in plain torch.

It imports nothing of the program under test and takes nothing the program
made: it works from the generator's own arrays (``gen.generate``).  It runs
on any torch device, in blocks of rows of at most ``block_flops`` candidates
each, so that it fits on the card beside what the harness still holds:
expansion of every A entry (i, k) into B's row k, one int64 key ``i * n +
j`` a candidate, ``torch.unique`` for the product, and for the triangles the
multiplicity of every product entry summed over A's own entries
(``torch.searchsorted`` membership).

The controls (``dedup=False``, ``multiplicity=False``) are the reference
with one guarantee of the configuration broken; the harness never runs them,
and ``control.py`` shows that the comparison refuses them.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BLOCK_FLOPS", "product_blocks", "triangle_sum"]

BLOCK_FLOPS = 1 << 27


def _row_blocks(indptr: np.ndarray, indices: np.ndarray, block_flops: int):
    """Contiguous row bounds whose candidates stay under ``block_flops``
    (a row heavier than that is a block of its own)."""
    lens = np.diff(indptr)
    per_entry = lens[indices]
    csum = np.concatenate([[0], np.cumsum(per_entry, dtype=np.int64)])
    row_end = csum[indptr]  # candidates before each row
    bounds, r0, n = [0], 0, len(indptr) - 1
    while r0 < n:
        r1 = int(np.searchsorted(row_end, row_end[r0] + block_flops, side="right")) - 1
        r1 = min(max(r1, r0 + 1), n)
        bounds.append(r1)
        r0 = r1
    return bounds


def _block_keys(ptr, idx, indptr, r0: int, r1: int, n: int, device):
    """Every candidate key ``i * n + j`` of rows [r0, r1) of A·A, unsorted."""
    e0, e1 = int(indptr[r0]), int(indptr[r1])
    lens = ptr[1:] - ptr[:-1]
    k = idx[e0:e1]
    a_rows = torch.repeat_interleave(
        torch.arange(r0, r1, device=device, dtype=torch.int64), lens[r0:r1])
    cnt = lens[k]
    total = int(cnt.sum())
    ent = torch.repeat_interleave(torch.arange(e1 - e0, device=device), cnt,
                                  output_size=total)
    start = torch.cumsum(cnt, 0) - cnt
    off = torch.arange(total, device=device, dtype=torch.int64) - start[ent]
    cols = idx[ptr[k][ent] + off]
    return a_rows[ent] * n + cols


def _upload(indptr, indices, device):
    ptr = torch.from_numpy(np.asarray(indptr, np.int64)).to(device)
    idx = torch.from_numpy(np.asarray(indices).astype(np.int64)).to(device)
    return ptr, idx


def product_blocks(indptr, indices, n: int, device, *, dedup: bool = True,
                   block_flops: int = BLOCK_FLOPS):
    """Yield ``(r0, r1, keys)`` over row blocks of A·A: ``keys`` the sorted
    int64 ``row * n + col`` of the block's entries on ``device``, unique
    (``dedup=False``, the control, keeps every candidate)."""
    ptr, idx = _upload(indptr, indices, device)
    bounds = _row_blocks(indptr, indices, block_flops)
    for r0, r1 in zip(bounds, bounds[1:]):
        keys = _block_keys(ptr, idx, indptr, r0, r1, n, device)
        keys = torch.unique(keys) if dedup else torch.sort(keys).values
        yield r0, r1, keys


def triangle_sum(indptr, indices, n: int, device, *, multiplicity: bool = True,
                 block_flops: int = BLOCK_FLOPS) -> int:
    """The sum over A's entries (i, j) of the multiplicity of (A·A)[i, j]:
    six times the triangles of a symmetric, hollow A.  ``multiplicity=False``
    (the control) counts each such entry once, the boolean product's
    support."""
    ptr, idx = _upload(indptr, indices, device)
    lens = ptr[1:] - ptr[:-1]
    a_keys = torch.repeat_interleave(
        torch.arange(n, device=device, dtype=torch.int64), lens) * n + idx
    if a_keys.numel() == 0:
        return 0
    total = 0
    bounds = _row_blocks(indptr, indices, block_flops)
    for r0, r1 in zip(bounds, bounds[1:]):
        keys, counts = torch.unique(
            _block_keys(ptr, idx, indptr, r0, r1, n, device), return_counts=True)
        pos = torch.searchsorted(a_keys, keys).clamp_(max=a_keys.numel() - 1)
        member = a_keys[pos] == keys
        weights = counts if multiplicity else torch.ones_like(counts)
        total += int(weights[member].sum())
    return total
