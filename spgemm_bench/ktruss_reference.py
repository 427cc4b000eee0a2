"""The plain reference of the k-truss: the synchronous peel in plain torch.

It imports nothing of the program under test and takes nothing the program
made: it works from the generator's own arrays (``gen.generate``).  Each
round takes G_r, the graph left so far, as a host CSR, expands G_r·G_r in
blocks of rows of at most ``block_flops`` candidates each on ``device``
(``reference.py``'s expansion: one int64 key ``i * n + j`` a candidate),
counts every key with ``torch.unique``, and gives each edge of G_r the count
of its own key (0 where no candidate lands on it): its support, the common
neighbours it has in G_r.  The edges with support at least k - 2 stay; the
peel stops once a round drops nothing, or nothing is left.  Integers only,
so the comparison with it is exact.

``max_rounds`` stops it early: the control, a peel cut after its first
round, which the comparison has to refuse.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import _block_keys, _row_blocks, _upload

__all__ = ["BLOCK_FLOPS", "Peel", "peel"]

# Smaller blocks than the product reference's: the peel runs in the cell's
# set-up, before the program stages anything, and its blocks' scratch must
# stay well under the program's own peak.
BLOCK_FLOPS = 1 << 24


class Peel:
    """A finished peel: the truss ``(indptr, indices)`` on the host, its
    sorted int64 keys ``row * n + col`` on the device, and each support
    round's entries and Gustavson flops (``nnz[r]``, ``flops[r]`` of G_r)."""

    def __init__(self, indptr, indices, n: int, keys, nnz: list, flops: list):
        self.indptr, self.indices, self.n = indptr, indices, n
        self.keys, self.nnz, self.flops = keys, nnz, flops

    @property
    def rounds(self) -> int:
        return len(self.flops)


def _support(indptr, indices, n: int, device, block_flops: int) -> np.ndarray:
    """Each entry's count of candidates of G·G landing on it, in G's entry
    order (int64, on the host)."""
    ptr, idx = _upload(indptr, indices, device)
    lens = ptr[1:] - ptr[:-1]
    rows = torch.repeat_interleave(torch.arange(n, device=device, dtype=torch.int64), lens)
    edges = rows * n + idx  # ascending: G is canonical
    out = torch.zeros(len(indices), dtype=torch.int64, device=device)
    bounds = _row_blocks(indptr, indices, block_flops)
    for r0, r1 in zip(bounds, bounds[1:]):
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        keys, counts = torch.unique(_block_keys(ptr, idx, indptr, r0, r1, n, device),
                                    return_counts=True)
        if keys.numel() == 0 or e0 == e1:
            continue
        want = edges[e0:e1]
        pos = torch.searchsorted(keys, want).clamp_(max=keys.numel() - 1)
        out[e0:e1] = torch.where(keys[pos] == want, counts[pos], 0)
    return out.cpu().numpy()


def peel(indptr, indices, n: int, k: int, device, *, max_rounds: int | None = None,
         block_flops: int = BLOCK_FLOPS) -> Peel:
    """The k-truss of the canonical CSR ``(indptr, indices)`` by the
    synchronous peel (``max_rounds`` support rounds at most)."""
    if k < 3:
        raise ValueError("k-truss needs k >= 3")
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    nnz, flops = [], []
    while len(indices) and (max_rounds is None or len(flops) < max_rounds):
        lens = np.diff(indptr)
        nnz.append(len(indices))
        flops.append(int(lens[indices].sum()))
        keep = _support(indptr, indices, n, device, block_flops) >= k - 2
        if keep.all():
            break
        kept = np.r_[0, np.cumsum(keep, dtype=np.int64)]
        indptr, indices = kept[indptr], indices[keep]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keys = torch.from_numpy(rows * n + indices).to(device)
    return Peel(indptr, indices.astype(np.int32), n, keys, nnz, flops)
