"""Blocked boolean CSR: block-level sparsity over dense boolean tiles.

Counterpart of ``binary_spgemm_tpu/formats/bbcsr.py``, in numpy on the host.
Each nonzero ``b x b`` block is a dense 0/1 tile (128 x 128 on the blocked
route, a tensor-core-sized unit), and the block-level structure is itself a
:class:`..formats.bcsr.BCSR` over block coordinates.  Multiply with
:func:`..ops.bsr.bsr_spgemm`.  The format pays off when nonzeros cluster
into blocks; for uniform hyper-sparse matrices block occupancy is ~d/b² and
it only adds work.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .bcsr import BCSR, bcsr_from_arrays

__all__ = ["BlockedBCSR", "blocked_from_arrays"]


@dataclasses.dataclass
class BlockedBCSR:
    """Block-sparse boolean matrix: block-level BCSR + dense per-block tiles.

    ``structure`` is a BCSR of shape (n_brows, n_bcols) whose k-th stored entry
    corresponds to ``blocks[k]`` — a dense (b, b) uint8 0/1 tile.  Entries
    within a block row are stored with ascending block-column (canonical).
    """

    structure: BCSR
    blocks: np.ndarray  # uint8 [n_blocks, b, b]
    block_size: int
    shape: tuple[int, int]  # element-level shape (pre-padding)

    @property
    def n_blocks(self) -> int:
        return int(self.structure.nnz)

    @property
    def nnz(self) -> int:
        return int(self.blocks.sum())

    @classmethod
    def from_bcsr(cls, mat: BCSR, block_size: int = 128) -> "BlockedBCSR":
        """Build from element-level CSR."""
        b = block_size
        rows, cols = mat.to_coo()
        brow, bcol = rows // b, cols // b
        n_brows = -(-mat.n_rows // b)
        n_bcols = -(-mat.n_cols // b)
        bkey = brow * n_bcols + bcol
        order = np.argsort(bkey, kind="stable")
        bkey_s = bkey[order]
        uniq, inv_first = np.unique(bkey_s, return_index=True)
        n_blocks = len(uniq)
        blocks = np.zeros((max(n_blocks, 1), b, b), dtype=np.uint8)
        block_of = np.searchsorted(uniq, bkey)  # block slot per element
        blocks[block_of, rows % b, cols % b] = 1
        structure = BCSR.from_coo(
            uniq // n_bcols, uniq % n_bcols, (n_brows, n_bcols)
        )
        return cls(structure, blocks[:n_blocks], b, tuple(mat.shape))

    def to_bcsr(self) -> BCSR:
        """Flatten back to element-level canonical CSR."""
        b = self.block_size
        brows, bcols = self.structure.to_coo()
        k, r, c = np.nonzero(self.blocks) if self.n_blocks else (
            np.zeros(0, int), np.zeros(0, int), np.zeros(0, int)
        )
        rows = brows[k] * b + r
        cols = bcols[k] * b + c
        keep = (rows < self.shape[0]) & (cols < self.shape[1])
        mat = BCSR.from_coo(rows[keep], cols[keep], self.shape)
        return mat.sum_duplicates()

    def block_occupancy(self) -> float:
        """Mean fraction of set bits per stored block (density diagnostic)."""
        if self.n_blocks == 0:
            return 0.0
        return float(self.blocks.mean())

    def __repr__(self):
        return (
            f"BlockedBCSR(shape={self.shape}, b={self.block_size}, "
            f"blocks={self.n_blocks}, occupancy={self.block_occupancy():.3f})"
        )


def blocked_from_arrays(indptr, indices, blocks, block_size, shape) -> BlockedBCSR:
    """A :class:`BlockedBCSR` from plain arrays (e.g. another package's
    blocked matrix, handed over as its structure's numpy ``indptr`` and
    ``indices``, its tiles, block size and element shape).  The arrays are
    copied, so the result shares no memory with the caller's."""
    b = int(block_size)
    shape = (int(shape[0]), int(shape[1]))
    block_shape = (-(-shape[0] // b), -(-shape[1] // b))
    structure = bcsr_from_arrays(indptr, indices, block_shape)
    tiles = np.array(blocks, dtype=np.uint8, copy=True)
    if tiles.shape != (structure.nnz, b, b):
        raise ValueError(
            f"blocks shape {tiles.shape} does not match {structure.nnz} "
            f"stored blocks of {b}x{b}"
        )
    return BlockedBCSR(structure, tiles, b, shape)
