"""Blocked boolean SpGEMM on the tensor cores.

Counterpart of ``binary_spgemm_tpu/ops/bsr.py``: block-level Gustavson over
:class:`..formats.bbcsr.BlockedBCSR`.

* **block-pair expansion** — the block-level structure walk, host-side in
  vectorised numpy (:func:`block_pairs`; stable orders, so the port's pair
  plans are element-equal to the JAX package's);
* **grouped dense tile products** — every (A-block, B-block) pair is a bf16
  ``b x b x b`` product with f32 counts (0/1 values, so the counts are exact),
  accumulated per output block by K3 (:mod:`.block_matmul`);
* ``count > 0`` is the boolean OR.

On uniform hyper-sparse inputs block occupancy is ~d/b² and the route only
adds work; on block-clustered inputs it turns sparse bookkeeping into dense
tensor-core products.  :func:`maybe_bsr_executor` is the routing screen that
``auto_executor``, ``cached_executor(allow_bsr=True)`` and ``spgemm`` consult.
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats.bbcsr import BlockedBCSR
from ..formats.bcsr import BCSR
from .block_matmul import grouped_block_matmul
from .spgemm import pad_bucket, resolve_device

__all__ = [
    "BSR_MAX_STAGED_BYTES",
    "BSR_MIN_OCCUPANCY",
    "BsrExecutor",
    "BsrStagedExecutor",
    "PAIR_CHUNK",
    "block_clustering_ratio",
    "block_pairs",
    "bsr_spgemm",
    "maybe_bsr_executor",
]


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


# Pair-chunk size of the ``backend="xla"`` composition (bounds device
# memory: 2 x chunk x b² gathered operands, verbatim).
PAIR_CHUNK = 512


def block_pairs(
    a: BlockedBCSR, b: BlockedBCSR
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All (A-block, B-block) products and their output blocks, host-side.

    Returns ``(ka, kb, seg, out_brow, out_bcol)``: pair p multiplies A-block
    ``ka[p]`` with B-block ``kb[p]`` into output block ``seg[p]`` (pairs sorted
    by seg); output block s has block coords (out_brow[s], out_bcol[s]).
    """
    sa, sb = a.structure, b.structure
    arow, acol = sa.to_coo()  # block coords of A's stored blocks
    lens = np.diff(sb.indptr)[acol]
    ka = np.repeat(np.arange(sa.nnz, dtype=np.int64), lens)
    offs = np.concatenate([[0], np.cumsum(lens)])[:-1]
    total = int(lens.sum())
    kb = (
        np.arange(total, dtype=np.int64)
        - np.repeat(offs, lens)
        + np.repeat(sb.indptr[acol], lens)
    )
    out_i = np.repeat(arow, lens)
    out_k = sb.indices[kb]
    okey = out_i * np.int64(sb.n_cols) + out_k
    order = np.argsort(okey, kind="stable")
    ka, kb, okey = ka[order], kb[order], okey[order]
    uniq, seg = np.unique(okey, return_inverse=True)
    return ka, kb, seg, uniq // sb.n_cols, uniq % sb.n_cols


def _pair_matmul_accumulate(a_blocks, b_blocks, ka, kb, seg, acc):
    """The ``backend="xla"`` step for one chunk of pairs: gather the tiles,
    an f32 ``torch.bmm``, ``index_add_`` into ``acc`` in place (f32
    ``[n_out_pad, b, b]``; every ``seg`` lies inside it by construction — the
    padded tail targets the scratch segment ``n_out_pad - 1``)."""
    prod = torch.bmm(
        torch.index_select(a_blocks, 0, ka).float(),
        torch.index_select(b_blocks, 0, kb).float(),
    )
    return acc.index_add_(0, seg, prod)


def _pad_pair_plan(ka, kb, seg, n_out):
    """Bucket-pad the (ka, kb, seg) pair plan; tail pairs target a scratch
    segment ``n_out`` (dropped by callers).  ``first`` marks each output
    block's first pair (zero-init) including the scratch block's."""
    npairs = len(ka)
    npairs_pad = pad_bucket(max(npairs, 1), minimum=1)
    seg_p = np.full(npairs_pad, n_out, np.int32)
    ka_p = np.zeros(npairs_pad, np.int32)
    kb_p = np.zeros(npairs_pad, np.int32)
    seg_p[:npairs] = seg
    ka_p[:npairs] = ka
    kb_p[:npairs] = kb
    first = np.zeros(npairs_pad, np.int32)
    if npairs:
        first[0] = 1
        first[1:npairs] = (np.diff(seg) != 0).astype(np.int32)
    if npairs < npairs_pad:
        first[npairs] = 1  # init the scratch block
    return seg_p, ka_p, kb_p, first


def _stage_tiles(blocks: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 0/1 tiles as contiguous bf16 on ``device`` (uploaded as uint8,
    a quarter of the bytes, and widened there)."""
    return torch.from_numpy(np.ascontiguousarray(blocks)).to(device).to(
        torch.bfloat16
    )


def _threshold(counts: torch.Tensor, n_out: int) -> np.ndarray:
    """uint8 ``counts[:n_out] > 0`` on the host: thresholded where the counts
    are, so the pull moves a byte per entry instead of four."""
    return (counts[:n_out] > 0).to(torch.uint8).cpu().numpy()


class BsrExecutor:
    """Pre-staged repeated blocked C = A·B on the tensor cores.

    Stages the bf16 tile arrays and the (padded) pair plan on ``device`` once,
    so each :meth:`run` is one K3 launch.  ``run`` returns the f32
    per-output-block count tiles; :meth:`assemble` thresholds and packs them
    into a :class:`BlockedBCSR`.
    """

    def __init__(
        self,
        a: BlockedBCSR,
        b: BlockedBCSR,
        *,
        device: str | torch.device = "cuda",
    ):
        if a.block_size != b.block_size:
            raise ValueError("block sizes must match")
        if a.structure.n_cols != b.structure.n_rows:
            raise ValueError(f"block shape mismatch: {a.shape} @ {b.shape}")
        self.device = resolve_device(device)
        self.bs = a.block_size
        self.shape = (a.shape[0], b.shape[1])
        self.block_shape = (a.structure.n_rows, b.structure.n_cols)
        ka, kb, seg, self.obr, self.obc = block_pairs(a, b)
        self.n_out = len(self.obr)
        self.npairs = len(ka)
        self.a_dev = _stage_tiles(a.blocks, self.device)
        self.b_dev = _stage_tiles(b.blocks, self.device)
        seg_p, ka_p, kb_p, first = _pad_pair_plan(ka, kb, seg, self.n_out)
        self.seg, self.ka, self.kb, self.first = (
            torch.from_numpy(x).to(self.device) for x in (seg_p, ka_p, kb_p, first)
        )

    def run(self) -> torch.Tensor:
        """f32 [n_out+1, b, b] per-output-block pair-product counts (on the
        device); the last block is padding scratch, zeros here.

        The staged plan keeps the JAX package's padded tail, but K3 runs
        over the real pairs only (views of the staged arrays): the tail
        bounded the TPU's compiled shapes, and here all its pairs would go
        to the scratch block, whose one thread block runs them one after
        another."""
        n = self.npairs
        return grouped_block_matmul(
            self.seg[:n], self.ka[:n], self.kb[:n], self.first[:n],
            self.a_dev, self.b_dev,
            n_out=self.n_out + 1,
        )

    def assemble(self, counts: torch.Tensor) -> BlockedBCSR:
        blocks = _threshold(counts, self.n_out)
        nonzero = blocks.reshape(self.n_out, -1).any(axis=1) if self.n_out else (
            np.zeros(0, bool)
        )
        structure = BCSR.from_coo(
            self.obr[nonzero], self.obc[nonzero], self.block_shape
        )
        return BlockedBCSR(structure, blocks[nonzero], self.bs, self.shape)


class BsrStagedExecutor:
    """:func:`..ell.auto_executor`-compatible facade over :class:`BsrExecutor`.

    Same staged contract as the sort engines — build once, then
    ``assemble(run())`` returns a flat canonical :class:`BCSR` — so the auto
    router can hand block-clustered inputs to the blocked engine without
    callers noticing.  ``run()`` leaves the f32 count tiles on the device;
    ``assemble`` thresholds them there, pulls the bytes and flattens them on
    the host.
    """

    engine = "bsr"

    def __init__(
        self,
        a: BCSR,
        b: BCSR,
        block: int = 128,
        *,
        device: str | torch.device = "cuda",
        _blocked: "tuple[BlockedBCSR, BlockedBCSR] | None" = None,
    ):
        self.block = block
        if _blocked is not None:
            self._blk_a, self._blk_b = _blocked
        else:
            self._blk_a = BlockedBCSR.from_bcsr(a, block)
            self._blk_b = (
                self._blk_a if b is a else BlockedBCSR.from_bcsr(b, block)
            )
        self._ex = BsrExecutor(self._blk_a, self._blk_b, device=device)
        # auto_executor-facade diagnostics, as the JAX package names them
        self.n_chunks = 1
        self.n_pairs = int(self._ex.seg.shape[0])
        self.n_out = self._ex.n_out

    def run(self) -> torch.Tensor:
        return self._ex.run()

    def assemble(self, counts: torch.Tensor) -> BCSR:
        return self._ex.assemble(counts).to_bcsr()


# Staged-route screen for the blocked engine (consulted by
# ``ops.ell.auto_executor`` / ``cached_executor(allow_bsr=True)``), verbatim.
# The routing signal is the mean occupancy of TOUCHED block tiles
# (block_clustering_ratio / block²): the blocked path spends b³ dense MACs per
# block pair whatever the occupancy, so its advantage over the sort engines
# grows with occupancy.  Uniform random inputs sit near d/b² (~1e-4).
BSR_MIN_OCCUPANCY = 0.05
# Staged tile bytes (bf16 operands + f32 accumulator) the route may pin in
# device memory; past this the sort engines take the product.
BSR_MAX_STAGED_BYTES = 2 << 30


def maybe_bsr_executor(
    a: BCSR, b: BCSR, *, device: str | torch.device = "cuda"
) -> "BsrStagedExecutor | None":
    """The staged blocked executor when the operands are block-clustered
    enough for it, else ``None`` (the caller goes on to the sort engines).
    Cheap screen first (sampled clustering ratio, O(min(nnz, 2^19))), then
    the exact byte budget on the built plan."""
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
    try:
        blk_a = BlockedBCSR.from_bcsr(a, block)
        blk_b = blk_a if b is a else BlockedBCSR.from_bcsr(b, block)
        # exact byte budget BEFORE anything touches the device: operand
        # tiles (bf16) + the accumulator (f32, one tile per output block)
        n_out = len(np.unique(block_pairs(blk_a, blk_b)[2]))
        staged_bytes = (
            (blk_a.n_blocks + blk_b.n_blocks) * b2 * 2 + (n_out + 1) * b2 * 4
        )
        if staged_bytes > BSR_MAX_STAGED_BYTES:
            return None
        return BsrStagedExecutor(
            a, b, block, device=device, _blocked=(blk_a, blk_b)
        )
    except (ValueError, MemoryError):
        return None


def bsr_spgemm(
    a: BlockedBCSR,
    b: BlockedBCSR,
    *,
    mask: BlockedBCSR | None = None,
    backend: str = "auto",
    device: str | torch.device = "cuda",
) -> BlockedBCSR:
    """Blocked boolean SpGEMM: C = A·B structure over dense tensor-core tiles.

    ``mask`` applies C = mask .* (A·B) block-wise: output blocks outside the
    mask's block structure are dropped entirely, in-mask blocks are ANDed
    with the mask tile.

    ``backend``: ``"pallas"`` — the grouped kernel K3
    (:func:`.block_matmul.grouped_block_matmul`; its plain version on the
    CPU); ``"xla"`` — chunked gather + ``torch.bmm`` + ``index_add_``;
    ``"auto"`` — K3.  The names are the JAX package's.
    """
    if mask is not None and (
        mask.block_size != a.block_size or mask.shape != (a.shape[0], b.shape[1])
    ):
        raise ValueError("mask must share block size and product shape")
    if a.block_size != b.block_size:
        raise ValueError("block sizes must match")
    if a.structure.n_cols != b.structure.n_rows:
        raise ValueError(f"block shape mismatch: {a.shape} @ {b.shape}")
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    device = resolve_device(device)
    bs = a.block_size
    shape = (a.shape[0], b.shape[1])
    ka, kb, seg, obr, obc = block_pairs(a, b)
    n_out = len(obr)
    if n_out == 0:
        structure = BCSR(
            np.zeros(a.structure.n_rows + 1, np.int32),
            np.zeros(0, np.int32),
            (a.structure.n_rows, b.structure.n_cols),
        )
        return BlockedBCSR(structure, np.zeros((0, bs, bs), np.uint8), bs, shape)

    a_dev = _stage_tiles(a.blocks, device)
    b_dev = _stage_tiles(b.blocks, device)
    npairs = len(ka)

    def up(x):
        return torch.from_numpy(x).to(device)

    if backend in ("auto", "pallas"):
        # the real pairs only (see BsrExecutor.run); the scratch block
        # n_out stays zero and is dropped
        seg_p, ka_p, kb_p, first = (
            x[:npairs] for x in _pad_pair_plan(ka, kb, seg, n_out)
        )
        counts = grouped_block_matmul(
            up(seg_p), up(ka_p), up(kb_p), up(first), a_dev, b_dev,
            n_out=n_out + 1,
        )
        blocks = _threshold(counts, n_out)
    else:
        # +1 guarantees a scratch segment: padded tail pairs accumulate there
        # and are discarded, keeping every chunk the same shape
        n_out_pad = pad_bucket(n_out + 1, minimum=2)
        acc = torch.zeros((n_out_pad, bs, bs), dtype=torch.float32, device=device)
        for p0 in range(0, npairs, PAIR_CHUNK):
            chunk = slice(p0, min(p0 + PAIR_CHUNK, npairs))
            cka = np.zeros(PAIR_CHUNK, np.int32)
            ckb = np.zeros(PAIR_CHUNK, np.int32)
            cseg = np.full(PAIR_CHUNK, n_out_pad - 1, np.int32)
            w = chunk.stop - chunk.start
            cka[:w], ckb[:w] = ka[chunk], kb[chunk]
            cseg[:w] = seg[chunk]
            _pair_matmul_accumulate(a_dev, b_dev, up(cka), up(ckb), up(cseg), acc)
        blocks = _threshold(acc, n_out)

    if mask is not None:
        # block-wise AND with the mask: match output blocks to mask blocks by
        # block coordinate; unmatched output blocks vanish
        n_bcols = b.structure.n_cols
        mrow, mcol = mask.structure.to_coo()
        mkeys = mrow * np.int64(n_bcols) + mcol
        okeys = obr * np.int64(n_bcols) + obc
        if len(mkeys) == 0:
            blocks = np.zeros_like(blocks)
        else:
            pos_c = np.minimum(np.searchsorted(mkeys, okeys), len(mkeys) - 1)
            inmask = mkeys[pos_c] == okeys
            blocks = np.where(
                inmask[:, None, None], blocks & mask.blocks[pos_c], 0
            ).astype(np.uint8)

    # drop all-zero output blocks (a structural block pair can yield no bits)
    nonzero = blocks.reshape(n_out, -1).any(axis=1)
    blocks = blocks[nonzero]
    structure = BCSR.from_coo(
        obr[nonzero], obc[nonzero],
        (a.structure.n_rows, b.structure.n_cols),
    )
    return BlockedBCSR(structure, blocks, bs, shape)
