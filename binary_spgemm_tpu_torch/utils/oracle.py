"""Ground-truth oracle for boolean SpGEMM.

scipy's CSR matmul is an independent C++ Gustavson implementation; after
``sort_indices()`` its canonical form (ascending, deduplicated columns per
row) is the output convention of every engine here.
"""
from __future__ import annotations

from ..formats.bcsr import BCSR

__all__ = ["masked_spgemm_oracle", "spgemm_oracle"]


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
