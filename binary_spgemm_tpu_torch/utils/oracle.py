"""Ground-truth oracle for boolean SpGEMM.

scipy's CSR matmul is an independent C++ Gustavson implementation; after
``sort_indices()`` its canonical form (ascending, deduplicated columns per
row) is the output convention of every engine here.
"""
from __future__ import annotations

import numpy as np

from ..formats.bcsr import BCSR

__all__ = [
    "masked_spgemm_oracle",
    "spgemm_dense_oracle",
    "spgemm_oracle",
    "union_oracle",
]


def spgemm_oracle(a: BCSR, b: BCSR) -> BCSR:
    """Structure of C = A·B over the boolean (OR/AND) semiring."""
    c = a.to_scipy() @ b.to_scipy()
    c.sort_indices()
    # counts >= 1 everywhere, so the structure IS the boolean product's
    return BCSR(c.indptr, c.indices, c.shape)


def masked_spgemm_oracle(f: BCSR, a: BCSR, b: BCSR) -> BCSR:
    """Structure of C = F .* (A·B)."""
    c = (a.to_scipy() @ b.to_scipy()).multiply(f.to_scipy())
    c = c.tocsr()
    c.sort_indices()
    c.eliminate_zeros()
    return BCSR(c.indptr, c.indices, c.shape)


def union_oracle(a: BCSR, b: BCSR) -> BCSR:
    """Structure of A OR B."""
    c = (a.to_scipy() + b.to_scipy()).tocsr()
    c.sort_indices()
    return BCSR(c.indptr, c.indices, c.shape)


def spgemm_dense_oracle(a: BCSR, b: BCSR) -> np.ndarray:
    """Dense boolean A·B at tiny sizes, independent of scipy."""
    return (a.to_dense().astype(np.int64) @ b.to_dense().astype(np.int64)) > 0
