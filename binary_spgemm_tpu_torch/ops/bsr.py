"""The blocked (tensor-core) route's screen.

Counterpart of the routing half of ``binary_spgemm_tpu/ops/bsr.py``: the
sampled block-clustering ratio and the conditions under which the JAX
package hands a product to its blocked engine.  The blocked engine itself
(kernel K3, ``ops/pallas_bsr.py::grouped_block_matmul``) is not ported yet,
so where the screen would take it this module raises.
"""
from __future__ import annotations

import numpy as np

from ..formats.bcsr import BCSR

__all__ = ["BSR_MIN_OCCUPANCY", "block_clustering_ratio", "maybe_bsr_executor"]

# Minimum mean tile occupancy for the blocked route (verbatim).
BSR_MIN_OCCUPANCY = 0.05


def block_clustering_ratio(mat: BCSR, block: int = 128) -> float:
    """Mean nonzeros per touched ``block x block`` tile (1 ~ uniform scatter,
    >> 1 ~ block-clustered), from a strided sample of at most 2^19 entries."""
    if mat.nnz == 0:
        return 0.0
    k = min(mat.nnz, 1 << 19)
    pos = np.linspace(0, mat.nnz - 1, k).astype(np.int64)
    rows = np.searchsorted(mat.indptr, pos, side="right") - 1
    n_bcols = -(-mat.n_cols // block)
    keys = (rows // block) * n_bcols + mat.indices[pos] // block
    # the sample estimates the touched-tile count; the numerator stays the
    # full nnz
    return mat.nnz / len(np.unique(keys))


def maybe_bsr_executor(a: BCSR, b: BCSR) -> None:
    """``None`` when the operands are not block-clustered enough for the
    blocked route (the caller goes on to the sort engines); raises
    ``NotImplementedError`` where the JAX package's screen would build its
    blocked executor."""
    block = 128
    b2 = block * block
    if a.nnz == 0 or b.nnz == 0:
        return None
    # only meaningful at scale: tiny shapes make the per-tile ratio noise
    if a.nnz < (1 << 17) or min(*a.shape, *b.shape) < 2048:
        return None
    if block_clustering_ratio(a, block) / b2 < BSR_MIN_OCCUPANCY:
        return None
    if b is not a and block_clustering_ratio(b, block) / b2 < BSR_MIN_OCCUPANCY:
        return None
    raise NotImplementedError(
        "block-clustered operands take the blocked tensor-core route, which "
        "is not ported yet (ROADMAP.md, Queue 1 item 8 and kernel K3)"
    )
