"""Row-partitioned boolean SpGEMM over a ``torch.distributed`` group.

Counterpart of ``binary_spgemm_tpu/parallel/dist_spgemm.py``: the products,
the op family, and the counting family with the triangle count.  Each rank
is one shard of the JAX package's row mesh: the ``shard_fn`` of every
``shard_map`` becomes a function each rank runs on its own slice, and the
collectives go through :mod:`.comm`.

========================================  =================================
reference (MPI) / JAX (shard_map)         here (one rank a shard)
========================================  =================================
rank owns a contiguous row range          rank r owns rows
(:func:`.mesh.partition_rows`)            ``bounds[r]:bounds[r+1]``
inputs replicated, every rank reads       every rank stages alike in numpy
the whole file (final:309)                and uploads only its own slice
``MPI_Reduce`` / ``psum`` of nnz          one ``all_gather`` of the
``MPI_Gather`` / ``all_gather`` counts    per-chunk counts gives both
``psum`` of the triangles' two int32      :func:`.comm.all_reduce_sum` of
limbs ``(hi, lo)``                        one int64 a rank
``ppermute`` ring over B shards           :class:`.comm.RingShift`, step
                                          t + 1's transfer started before
                                          step t's expansion
host assembly / ``process_allgather``     every rank gathers the valid
                                          prefixes and holds the full C
the counts stack beside the indices       :attr:`Step.cnt`, gathered with
(``_two_level_ptr_fix_counts``,           the same valid-prefix compaction
``c_cnt=`` of the assembly)               as the indices; the assembly
                                          returns ``(BCSR, counts)``
========================================  =================================

Host staging (:func:`shard_operands`, :func:`_shard_ell_operands` and the
other ``_shard_*`` helpers) returns numpy arrays stacked over the ``S``
shards, element-equal to what the JAX package puts on its mesh; a rank
uploads row ``rank`` of each.  The per-rank steps (``dist_spgemm_sharded``,
``dist_spgemm_ell``, ...) return the rank's :class:`Step`: its sub-chunks'
row pointers, already prefix-fixed across chunks and ranks as the JAX
package's are, their padded indices and valid counts, and every rank's
counts.  :func:`_assemble` turns that into the full ``BCSR`` on every
rank.  The ELL steps stack a rank's sub-chunk streams as one ``[C,
sort_pad]`` array: P4 (packed keys) or P3 (pairs) gathers the class rows
in one launch, and :func:`..ops.spgemm.sort_compress_2d_keys` (K1 through
``sort_rows``) or the int64 pair sort compacts every sub-chunk at once; the
counting steps run :mod:`..ops.counts`' compressions and joins on the same
stack.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.bcsr import BCSR
from ..ops.counts import (
    _counts_compress,
    _empty_counts,
    _masked_counts,
    _masked_counts_sum,
    _triangles,
    masked_counts_compress,
    masked_counts_sum,
    sort_compress_counts,
)
from ..ops.spgemm import (
    INT,
    _indptr,
    _upload,
    compact_chunks,
    expand_pairs,
    pad_bucket,
    packable,
    require_int32_operands,
    row_flops,
    sort_compress,
    sort_compress_2d,
    sort_compress_2d_keys,
    sort_compress_masked,
)
from ..utils.trace import span
from . import comm
from .mesh import RowMesh, make_row_mesh, partition_rows

__all__ = [
    "ShardedOperands",
    "Step",
    "dist_masked_spgemm",
    "dist_masked_spgemm_counts",
    "dist_masked_spgemm_counts_ell",
    "dist_masked_spgemm_counts_sharded",
    "dist_masked_spgemm_ell",
    "dist_masked_spgemm_sharded",
    "dist_spgemm",
    "dist_spgemm_counts",
    "dist_spgemm_counts_ell",
    "dist_spgemm_counts_sharded",
    "dist_spgemm_ell",
    "dist_spgemm_or",
    "dist_spgemm_or_ell",
    "dist_spgemm_or_sharded",
    "dist_spgemm_ring",
    "dist_spgemm_ring_ell",
    "dist_spgemm_sharded",
    "dist_spgemm_sharded_b",
    "dist_spm_or",
    "dist_spm_or_sharded",
    "dist_triangle_count",
    "dist_triangle_sum_ell",
    "dist_triangle_sum_sharded",
    "ring_step_pad",
    "shard_b_operands",
    "shard_operands",
]


def _empty(n: int, m: int) -> BCSR:
    return BCSR(np.zeros(n + 1, np.int32), np.zeros(0, np.int32), (n, m))


def _mine(x: np.ndarray, mesh: RowMesh) -> torch.Tensor:
    """This rank's row of a stacked ``[S, ...]`` staging array, on its device."""
    return _upload(np.ascontiguousarray(x[mesh.rank]), mesh.device)


def _whole(x: np.ndarray, mesh: RowMesh) -> torch.Tensor:
    """A replicated staging array on this rank's device."""
    return _upload(np.ascontiguousarray(x, np.int32), mesh.device)


def _mesh(mesh: RowMesh | None, device) -> RowMesh:
    return mesh if mesh is not None else make_row_mesh(device=device)


# ---------------------------------------------------------------------------
# Host staging (numpy, alike on every rank)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedOperands:
    """Stacked operands of the row-partitioned product (host arrays; rank r
    uploads row r of the sharded ones)."""

    bounds: np.ndarray  # [S+1] row partition boundaries
    rows_pad: int
    a_ptr: np.ndarray  # [S, rows_pad+1] shard-local row pointers
    a_idx: np.ndarray  # [S, nnz_pad]   shard-local column indices
    a_nnz: np.ndarray  # [S, 1]          valid nnz per shard
    b_ptr: np.ndarray  # [m+1]           replicated
    b_idx: np.ndarray  # [nnz_b]         replicated
    flops_pad: int
    shape: tuple[int, int]


def _stack_rows_csr(f: BCSR, bounds: np.ndarray, rows_pad: int, pad: int,
                    fill: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rows ``bounds[s]:bounds[s+1]`` of ``f`` as stacked padded shard-local
    CSR: ``(ptrs [S, rows_pad+1] (trailing rows clamped to the shard's nnz),
    idxs [S, pad] (fill ``fill``), nnzs [S, 1])``."""
    n_shards = len(bounds) - 1
    ptrs = np.zeros((n_shards, rows_pad + 1), np.int32)
    idxs = np.full((n_shards, pad), fill, np.int32)
    nnzs = np.zeros((n_shards, 1), np.int32)
    for s, (r0, r1) in enumerate(zip(bounds, bounds[1:])):
        nnz_local = int(f.indptr[r1] - f.indptr[r0])
        ptrs[s, : r1 - r0 + 1] = f.indptr[r0 : r1 + 1] - f.indptr[r0]
        ptrs[s, r1 - r0 + 1 :] = nnz_local
        idxs[s, :nnz_local] = f.indices[f.indptr[r0] : f.indptr[r1]]
        nnzs[s, 0] = nnz_local
    return ptrs, idxs, nnzs


def shard_operands(
    a: BCSR,
    b: BCSR,
    n_shards: int,
    *,
    balance: str = "flops",
    flops_pad: int | None = None,
) -> ShardedOperands:
    """Partition A's rows over ``n_shards`` shards and stack their padded
    operands.  All shards share one padded shape; B is replicated — the
    reference's semantics (every rank holds the full B, :309)."""
    rf = row_flops(a, b)
    bounds = partition_rows(rf, n_shards, balance=balance)
    rows_pad = pad_bucket(int(np.max(np.diff(bounds))), minimum=1)
    nnz_pad = pad_bucket(
        int(max(a.indptr[r1] - a.indptr[r0] for r0, r1 in zip(bounds, bounds[1:])))
    )
    if flops_pad is None:
        flops_pad = pad_bucket(
            int(max(rf[r0:r1].sum() for r0, r1 in zip(bounds, bounds[1:])))
        )
    ptrs, idxs, nnzs = _stack_rows_csr(a, bounds, rows_pad, nnz_pad, 0)
    return ShardedOperands(
        bounds=bounds, rows_pad=rows_pad, a_ptr=ptrs, a_idx=idxs, a_nnz=nnzs,
        b_ptr=np.asarray(b.indptr), b_idx=np.asarray(b.indices),
        flops_pad=int(flops_pad), shape=(a.n_rows, b.n_cols),
    )


def _shard_rows_csr(f: BCSR, bounds: np.ndarray, rows_pad: int):
    """Row-slice a same-row-space side operand (mask F, fused D, union B)
    by the shard bounds: ``(ptrs [S, rows_pad+1], idxs [S, pad], nnzs [S,
    1])``, indices filled with ``n_cols``."""
    f_pad = pad_bucket(
        max(
            (int(f.indptr[r1] - f.indptr[r0]) for r0, r1 in zip(bounds, bounds[1:])),
            default=1,
        ),
        minimum=1,
    )
    return _stack_rows_csr(f, bounds, rows_pad, f_pad, f.n_cols)


def shard_b_operands(b: BCSR, n_shards: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Row-shard B: stacked shard-local row pointers ``[S, m_per+1]`` and
    padded indices ``[S, b_pad]`` (trailing shard rows beyond ``m`` empty).
    Returns ``(b_ptr_sh, b_idx_sh, m_per)``."""
    m = b.n_rows
    m_per = -(-m // n_shards)
    edges = np.minimum(np.arange(n_shards + 1) * m_per, m)
    b_pad = pad_bucket(int(np.max(np.diff(b.indptr[edges]))), minimum=1)
    if n_shards * b_pad > np.iinfo(np.int32).max:
        # the gathered layout addresses b_idx with int32 shard_base offsets
        raise OverflowError(
            f"gathered B layout {n_shards}x{b_pad} exceeds int32 addressing"
        )
    ptrs = np.zeros((n_shards, m_per + 1), np.int32)
    idxs = np.zeros((n_shards, b_pad), np.int32)
    for s in range(n_shards):
        r0, r1 = int(edges[s]), int(edges[s + 1])
        nnz_local = int(b.indptr[r1] - b.indptr[r0])
        ptrs[s, : r1 - r0 + 1] = b.indptr[r0 : r1 + 1] - b.indptr[r0]
        ptrs[s, r1 - r0 + 1 :] = nnz_local
        idxs[s, :nnz_local] = b.indices[b.indptr[r0] : b.indptr[r1]]
    return ptrs, idxs, m_per


def ring_step_pad(
    a: BCSR, b: BCSR, bounds: np.ndarray, m_per: int, n_shards: int
) -> int:
    """Uniform per-(shard, step) expansion pad for the ring schedule.

    Step t on shard s expands exactly the A-entries of shard s whose column
    lies in B-shard ``(s - t) mod S``'s row range; the pad is the max flop
    count over all (shard, B-shard) cells, bucket-rounded.
    """
    bl = np.diff(b.indptr).astype(np.int64)
    per_entry = bl[a.indices] if a.nnz else np.zeros(0, np.int64)
    rows = np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
    shard_of = np.searchsorted(bounds, rows, side="right") - 1
    src_of = np.minimum(a.indices // m_per, n_shards - 1)
    cell = np.bincount(
        shard_of * n_shards + src_of,
        weights=per_entry,
        minlength=n_shards * n_shards,
    )
    step_max = int(cell.max()) if cell.size else 0
    if step_max > np.iinfo(np.int32).max:
        raise OverflowError(f"ring step flop count {step_max} exceeds int32")
    return pad_bucket(step_max, minimum=8)


def _shard_ell_csr(f: BCSR, sub_bounds: np.ndarray, rows_pad: int):
    """Per-(shard, sub-chunk) padded chunk-local CSR arrays for a row-sharded
    side input (mask F, fused D): pointers ``[S, C, rows_pad+1]`` (trailing
    rows clamped to the chunk nnz) + indices ``[S, C, pad]`` (fill
    ``n_cols``)."""
    n_shards, C1 = sub_bounds.shape
    C = C1 - 1
    f_pad = pad_bucket(
        max(int(np.max(np.diff(f.indptr[sub_bounds], axis=1))), 1), minimum=1
    )
    ptrs = np.zeros((n_shards, C, rows_pad + 1), np.int32)
    idxs = np.full((n_shards, C, f_pad), f.n_cols, np.int32)
    for s in range(n_shards):
        p, i, _ = _stack_rows_csr(f, sub_bounds[s], rows_pad, f_pad, f.n_cols)
        ptrs[s], idxs[s] = p, i
    return ptrs, idxs


def _shard_b_ell_tables(ell, n_shards: int):
    """Slice every ELL class table by B-row range into per-shard slices.

    ``EllB.build`` assigns class slots in ascending B-row order, so B-shard
    ``j``'s rows of class ``c`` are the contiguous slice
    ``tables[c][cls_cuts[c][j]:cls_cuts[c][j+1]]``.  Returns stacked
    sentinel-padded slices ``[S, tbl_pad_c, w_c]`` per class, their pads,
    the cut arrays that translate in-class positions to slice-local ones,
    and ``m_per``."""
    m = ell.shape[0]
    m_per = -(-m // n_shards) if m else 1
    edges = np.minimum(np.arange(n_shards + 1) * m_per, m)
    tbl_sh, tbl_pads, cls_cuts = [], [], []
    for ci, tbl in enumerate(ell.tables):
        class_rows = np.flatnonzero(ell.class_of_row == ci)
        cuts = np.searchsorted(class_rows, edges).astype(np.int64)
        pad = pad_bucket(int(np.diff(cuts).max()) if n_shards else 1, minimum=1)
        st = np.full((n_shards, pad, tbl.shape[1]), ell.shape[1], np.int32)
        for s in range(n_shards):
            lo, hi = int(cuts[s]), int(cuts[s + 1])
            st[s, : hi - lo] = tbl[lo:hi]
        if n_shards * pad > np.iinfo(np.int32).max:
            raise OverflowError(
                f"sharded ELL table {n_shards}x{pad} exceeds int32 addressing"
            )
        tbl_sh.append(st)
        tbl_pads.append(pad)
        cls_cuts.append(cuts)
    return tbl_sh, tuple(tbl_pads), cls_cuts, m_per


def _balanced_chunk_bounds(rf: np.ndarray, budget: int, max_rows: int) -> list[int]:
    """Flop-equalised sub-chunk boundaries for the per-shard plan (verbatim
    from the JAX package): the greedy splitter's chunk COUNT, re-cut at
    equal cumulative-flop quantiles so every chunk, and so ``sort_pad``,
    shrinks with the shard's flop share; chunks past the row cap are split
    again.  Single-device plans keep the greedy splitter."""
    from ..ops.ell import _chunk_bounds

    greedy = _chunk_bounds(rf, budget, max_rows)
    C = len(greedy) - 1
    n = len(rf)
    if C <= 1:
        return greedy
    cum = np.concatenate([[0], np.cumsum(rf, dtype=np.int64)])
    total = int(cum[-1])
    if total <= 0:
        bounds = np.round(np.linspace(0, n, C + 1)).astype(np.int64)
    else:
        targets = (np.arange(1, C, dtype=np.int64) * total) // C
        cuts = np.searchsorted(cum, targets, side="left")
        bounds = np.concatenate([[0], cuts, [n]])
        bounds = np.maximum.accumulate(bounds)
    out = [0]
    for i in range(len(bounds) - 1):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        while hi - lo > max_rows:  # row-cap guard (quantiles ignore rows)
            lo += max_rows
            out.append(lo)
        if hi > out[-1]:
            out.append(hi)
    if out[-1] != n:
        out.append(n)
    return out


def _shard_ell_operands(
    a: BCSR,
    b: BCSR,
    n_shards: int,
    bounds: np.ndarray,
    rf: np.ndarray,
    *,
    b_tables: str = "replicated",
    extra_key_bits: int = 0,
    allow_batched: bool = False,
):
    """Per-(shard, chunk, class) ELL entry arrays and B's class tables.

    Each shard's rows are sub-chunked like the single-device executor's
    (flop-balanced, row-capped for packed sort keys); all shards share one
    chunk count C (trailing chunks empty where a shard needed fewer).
    Returns ``(tables, entry_rows, entry_pos, widths, pads, rows_pad,
    sort_pad, sub_bounds [S, C+1], batched)``, entry arrays ``[S, C,
    pad_c]``, tables ``[n_c, w]`` (replicated) or ``[S, tbl_pad_c, w]``
    slices (``b_tables="sharded"``, positions remapped into the gathered
    gap-padded layout).

    ``extra_key_bits``: the masked join spends 1 key bit, the fused-masked
    three-way join 2, so the packed row cap halves per bit.
    ``allow_batched``: past 16 packed sub-chunks a shard keeps the packed
    row cap and the plan is flagged ``batched``, unless its resident ``[C,
    sort_pad]`` stream passes ``ops.ell.BATCHED_MAX_SLOTS`` (read at call
    time), where it is re-planned unrolled."""
    from ..ops import ell as ell_mod

    with span("plan.tables", always=True):
        ell = ell_mod.EllB.build(b)
        rows_pc, pos_pc = ell_mod._build_class_entries(a, ell)
        widths = tuple(ell.widths)
        shift = int(b.n_cols).bit_length() + extra_key_bits
        cap = 1 << max(0, 30 - shift)

        if b_tables == "sharded":
            # class slots ascend with B row, so a position's source shard is a
            # searchsorted against the class cut array
            tbl_sh, tbl_pads, cls_cuts, _ = _shard_b_ell_tables(ell, n_shards)
            remapped = []
            for ci, pcls in enumerate(pos_pc):
                p = pcls.astype(np.int64)
                src = np.searchsorted(cls_cuts[ci], p, side="right") - 1
                remapped.append(
                    (src * tbl_pads[ci] + (p - cls_cuts[ci][src])).astype(np.int32)
                )
            pos_pc = remapped

    with span("plan.search", always=True):
        # plan before any staging, with the batched plan's skew guard
        for attempt_batched in ((allow_batched, False) if allow_batched else (False,)):
            per_shard_bounds = []
            batched = False
            for s in range(n_shards):
                r0, r1 = int(bounds[s]), int(bounds[s + 1])
                rf_s = rf[r0:r1]
                budget = max(int(rf_s.sum()) // 8, 1 << 19)
                shard_rows = max(r1 - r0, 1)
                need_packed = -(-shard_rows // cap) if cap else shard_rows + 1
                if cap >= 512 and need_packed <= 16:
                    max_rows = cap  # few packed sub-chunks: unrolled plan
                elif attempt_batched and cap >= 32 and 16 < need_packed <= 4096:
                    max_rows = cap  # many packed sub-chunks: one [C, sort_pad] sort
                    batched = True
                else:
                    max_rows = shard_rows  # unpacked 2-key sorts: keep C small
                sb = _balanced_chunk_bounds(rf_s, budget, max_rows) if r1 > r0 else [0, 0]
                per_shard_bounds.append([r0 + x for x in sb])
            C = max(len(sb) - 1 for sb in per_shard_bounds)
            sub_bounds = np.zeros((n_shards, C + 1), np.int64)
            for s, sb in enumerate(per_shard_bounds):
                sub_bounds[s, : len(sb)] = sb
                sub_bounds[s, len(sb) :] = sb[-1]  # trailing empty chunks
            rows_pad = pad_bucket(int(np.max(np.diff(sub_bounds, axis=1))) or 1, minimum=1)
            cuts_pc = [
                np.stack([np.searchsorted(rcls, sub_bounds[s]) for s in range(n_shards)])
                for rcls in rows_pc
            ]  # per class: [S, C+1]
            pads = tuple(
                pad_bucket(max(int(np.diff(c, axis=1).max()), 1), minimum=8)
                for c in cuts_pc
            )
            slots = sum(p * w for p, w in zip(pads, widths))
            sort_pad = pad_bucket(max(slots, 8))
            if batched and C * sort_pad > ell_mod.BATCHED_MAX_SLOTS:
                continue  # skew guard: re-plan unrolled
            break
    if slots > np.iinfo(np.int32).max:
        raise OverflowError(f"ELL shard expansion {slots} slots exceeds int32")
    tables = tbl_sh if b_tables == "sharded" else list(ell.tables)
    with span("plan.stage", always=True):
        er, ep = [], []
        for ci, (rcls, pcls, pad) in enumerate(zip(rows_pc, pos_pc, pads)):
            r = np.full((n_shards, C, pad), rows_pad, np.int32)
            p = np.zeros((n_shards, C, pad), np.int32)
            for s in range(n_shards):
                for c in range(C):
                    lo, hi = cuts_pc[ci][s, c], cuts_pc[ci][s, c + 1]
                    r[s, c, : hi - lo] = rcls[lo:hi] - sub_bounds[s, c]
                    p[s, c, : hi - lo] = pcls[lo:hi]
            er.append(r)
            ep.append(p)
    return tables, er, ep, widths, pads, rows_pad, sort_pad, sub_bounds, batched


def _ring_ell_entries(a: BCSR, ell, bounds: np.ndarray, cls_cuts: list, m_per: int,
                      rows_pad: int, n_shards: int):
    """Per-(A-shard, B-shard, class) entry arrays for the ELL ring schedule.

    Entry ``(row, col)`` of A is processed at the ring step where A-shard
    ``searchsorted(bounds, row)`` holds B-shard ``col // m_per``'s table
    slice; its position is local to that slice.  Returns per-class
    ``entry_rows``/``entry_pos`` of shape ``[S, S, ent_pad_c]`` (dim 1 = the
    source B shard) and the pads."""
    rows_g = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(a.indptr))
    cols = a.indices.astype(np.int64)
    ci_e = ell.class_of_row[cols]
    pos_e = ell.pos_in_class[cols].astype(np.int64)
    src_e = cols // m_per
    shard_e = np.searchsorted(bounds, rows_g, side="right") - 1
    er, ep, ent_pads = [], [], []
    for ci in range(len(ell.widths)):
        sel = ci_e == ci
        r, p, sde, srce = rows_g[sel], pos_e[sel], shard_e[sel], src_e[sel]
        lp = p - cls_cuts[ci][srce]  # slice-local table position
        key = sde * n_shards + srce
        cnt = np.bincount(key, minlength=n_shards * n_shards)
        pad = pad_bucket(int(cnt.max()) if len(r) else 1, minimum=8)
        order = np.argsort(key, kind="stable")
        starts = np.cumsum(cnt) - cnt
        cell_pos = np.arange(len(r)) - np.repeat(starts, cnt)
        er_c = np.full((n_shards, n_shards, pad), rows_pad, np.int32)
        ep_c = np.zeros((n_shards, n_shards, pad), np.int32)
        ko = key[order]
        er_c[ko // n_shards, ko % n_shards, cell_pos] = (
            r[order] - bounds[ko // n_shards]
        ).astype(np.int32)
        ep_c[ko // n_shards, ko % n_shards, cell_pos] = lp[order].astype(np.int32)
        er.append(er_c)
        ep.append(ep_c)
        ent_pads.append(pad)
    return er, ep, tuple(ent_pads)


def _shard_ring_ell_operands(a: BCSR, b: BCSR, n_shards: int, bounds: np.ndarray):
    """Operands of :func:`dist_spgemm_ring_ell`: B's class-table slices
    ``[S, tbl_pad_c, w]`` and per-(shard, source B shard, class) entry
    arrays.  Returns ``(tables, er, ep, widths, ent_pads, rows_pad,
    step_pad)``."""
    from ..ops.ell import EllB

    ell = EllB.build(b)
    widths = tuple(ell.widths)
    rows_pad = pad_bucket(int(np.max(np.diff(bounds))) or 1, minimum=1)
    tbl_sh, _, cls_cuts, m_per = _shard_b_ell_tables(ell, n_shards)
    er, ep, ent_pads = _ring_ell_entries(a, ell, bounds, cls_cuts, m_per, rows_pad,
                                         n_shards)
    step_pad = sum(p * w for p, w in zip(ent_pads, widths))
    if step_pad * n_shards > np.iinfo(np.int32).max:
        raise OverflowError(
            f"ring-ELL candidate buffer {step_pad * n_shards} slots exceeds int32"
        )
    return tbl_sh, er, ep, widths, ent_pads, rows_pad, step_pad


# ---------------------------------------------------------------------------
# The per-rank steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Step:
    """One rank's product: ``c_ptr [C, rows_pad+1]`` (int32, prefix-fixed
    across the rank's sub-chunks and the ranks before it, wrapping past
    2^31 as the JAX package's do), ``c_idx [C, P]`` whose rows hold each
    sub-chunk's valid indices in a prefix, ``nnz [C]`` the valid counts and
    ``counts`` every rank's ``nnz`` (host, ``[S, C]`` int64).  The
    single-chunk steps have C = 1.  The counting steps carry ``cnt [C,
    P]``, each entry's multiplicity (int32) laid out as ``c_idx``: a
    payload the pointer fix leaves as it is (JAX's
    ``_two_level_ptr_fix_counts``)."""

    c_ptr: torch.Tensor
    c_idx: torch.Tensor
    nnz: torch.Tensor
    counts: np.ndarray
    cnt: torch.Tensor | None = None

    @property
    def total(self) -> int:
        return int(self.counts.sum())


def _ptr_fix(ptr: torch.Tensor, idx: torch.Tensor, nnz: torch.Tensor,
             mesh: RowMesh, cnt: torch.Tensor | None = None) -> Step:
    """The two-level pointer fix: each sub-chunk's offset within the rank
    plus the rank's offset over the group, from one gather of every rank's
    counts (≡ the reference's MPI_Reduce + MPI_Gather + displacement scan,
    final/SpGEMM_mpi_omp.c:178-196, and its intra-rank stitch :134-141).
    ``ptr [C, rows+1]``, ``idx [C, P]``, ``nnz [C]``; ``cnt`` (``[C, P]``,
    the counting steps) rides along unfixed."""
    with span("sync.ptr_fix"):
        counts = comm.all_gather_host(nnz.to(torch.int64), mesh).numpy()
    local = np.cumsum(counts[mesh.rank]) - counts[mesh.rank]
    off = torch.from_numpy(local + int(counts[: mesh.rank].sum())).to(ptr.device)
    fixed = (ptr.to(torch.int64) + off[:, None]).to(INT)  # int32 wrap, as JAX's
    return Step(fixed, idx, nnz, counts, cnt)


def _one(c_ptr, c_idx, nnz_c, mesh: RowMesh, cnt=None) -> Step:
    """:func:`_ptr_fix` of a single-chunk product (≡ ``_assembly_epilogue``)."""
    return _ptr_fix(c_ptr[None], c_idx[None], nnz_c.reshape(1), mesh,
                    None if cnt is None else cnt[None])


def dist_spgemm_sharded(a_ptr, a_idx, a_nnz: int, b_ptr, b_idx, *, mesh: RowMesh,
                        n_cols: int, flops_pad: int) -> Step:
    """This rank's ESC product of its row shard against the replicated B."""
    row, col = expand_pairs(a_ptr, a_idx, a_nnz, b_ptr, b_idx, n_cols=n_cols,
                            flops_pad=flops_pad, check_total=False)
    return _one(*sort_compress(row, col, a_ptr.shape[0] - 1, n_cols), mesh)


def dist_masked_spgemm_sharded(a_ptr, a_idx, a_nnz: int, f_ptr, f_idx, b_ptr, b_idx,
                               *, mesh: RowMesh, n_cols: int, flops_pad: int) -> Step:
    """This rank's masked ESC product C = F .* (A·B): F row-sharded with A
    (same bounds), the sort-fused mask join (``sort_compress_masked``).  The
    reference only declared its masked kernel parallelisable
    (final/SpGEMM_mpi_omp.c:229)."""
    from ..ops.spgemm import _row_ids

    rows_pad = a_ptr.shape[0] - 1
    row, col = expand_pairs(a_ptr, a_idx, a_nnz, b_ptr, b_idx, n_cols=n_cols,
                            flops_pad=flops_pad, check_total=False)
    f_rows = _row_ids(f_ptr, f_idx.shape[0])
    out = sort_compress_masked(row, col, f_rows, f_idx, f_ptr[-1], rows_pad, n_cols)
    return _one(*out, mesh)


def dist_spm_or_sharded(a_ptr, a_idx, a_nnz: int, b_ptr, b_idx, b_nnz: int, *,
                        mesh: RowMesh, n_cols: int) -> Step:
    """This rank's row union C = A OR B, both operands row-sharded by the
    same bounds (``spm_or_padded``)."""
    from ..ops.union import spm_or_padded

    return _one(*spm_or_padded(a_ptr, a_idx, a_nnz, b_ptr, b_idx, b_nnz,
                               n_cols=n_cols), mesh)


def dist_spgemm_or_sharded(d_ptr, d_idx, d_nnz: int, a_ptr, a_idx, a_nnz: int, b_ptr,
                           b_idx, f_ptr=None, f_idx=None, *, mesh: RowMesh, n_cols: int,
                           flops_pad: int) -> Step:
    """This rank's fused C = D OR (F.*?(A·B)): D (and F, when given)
    row-sharded with A, B replicated, the tagged sort-join of
    ``spgemm_or_padded`` (≡ the accumulate step of SpGEMM_dor,
    old/BSpGEMM.c:75-254, at cluster scale)."""
    from ..ops.fused import spgemm_or_padded

    return _one(*spgemm_or_padded(d_ptr, d_idx, d_nnz, a_ptr, a_idx, a_nnz, b_ptr,
                                  b_idx, f_ptr, f_idx, n_cols=n_cols,
                                  flops_pad=flops_pad, check_total=False), mesh)


def _gathered_rows(b_ptr_sh, b_idx_sh, mesh: RowMesh):
    """All-gather B's row shards in one call and address the gap-padded
    gathered layout: ``(starts [S*m_per], lens [S*m_per], flat indices)``."""
    b_pad, m_per = b_idx_sh.shape[0], b_ptr_sh.shape[0] - 1
    g = comm.all_gather(torch.cat([b_ptr_sh, b_idx_sh]), mesh)
    g_ptr, g_idx = g[:, : m_per + 1], g[:, m_per + 1 :]
    base = (torch.arange(g.shape[0], dtype=INT, device=g.device) * b_pad)[:, None]
    starts = (g_ptr[:, :-1] + base).reshape(-1)
    lens = (g_ptr[:, 1:] - g_ptr[:, :-1]).reshape(-1)
    return starts, lens, g_idx.reshape(-1)


def dist_spgemm_sharded_b(a_ptr, a_idx, a_nnz: int, b_ptr_sh, b_idx_sh, *,
                          mesh: RowMesh, n_cols: int, flops_pad: int) -> Step:
    """This rank's ESC product with **B row-sharded**: the rank holds 1/S of
    B, all-gathers the shards (one collective) and addresses the gathered
    gap-padded layout through generalised row starts and lengths."""
    starts, lens, b_flat = _gathered_rows(b_ptr_sh, b_idx_sh, mesh)
    row, col = expand_pairs(a_ptr, a_idx, a_nnz, None, b_flat, n_cols=n_cols,
                            flops_pad=flops_pad, b_row_starts=starts,
                            b_row_lens=lens, check_total=False)
    return _one(*sort_compress(row, col, a_ptr.shape[0] - 1, n_cols), mesh)


def _ring(held: torch.Tensor, mesh: RowMesh, expand) -> None:
    """The ring schedule: at step t this rank holds B shard ``(rank - t) mod
    S`` as the flat buffer ``held``; step t + 1's transfer (to rank + 1,
    from rank - 1) starts before ``expand(t, src, held)`` runs and is waited
    for after it.  The last step sends nothing (the JAX package's last
    ``ppermute`` only returns the shards to their owners)."""
    for t in range(mesh.size):
        nxt = comm.RingShift(held, mesh) if t + 1 < mesh.size else None
        expand(t, (mesh.rank - t) % mesh.size, held)
        if nxt is not None:
            held = nxt.wait()


def dist_spgemm_ring(a_ptr, a_idx, a_nnz: int, b_ptr_sh, b_idx_sh, *, mesh: RowMesh,
                     n_cols: int, m_per: int, step_pad: int) -> Step:
    """Ring-pipelined ESC step: B stays row-sharded and rotates through the
    group while each rank expands its candidates against the shard it holds
    (the collective-matmul pattern; B memory ``O(nnz(B)/S)`` for the whole
    multiply).  One sort/compress over the concatenated per-step candidates
    finishes the rank's rows."""
    n_rows = a_ptr.shape[0] - 1
    dev = a_idx.device
    row_buf = torch.empty((mesh.size, step_pad), dtype=INT, device=dev)
    col_buf = torch.empty((mesh.size, step_pad), dtype=INT, device=dev)
    n_ptr = b_ptr_sh.shape[0]

    def expand(t, src, held):
        ptr, idx = held[:n_ptr], held[n_ptr:]
        row_buf[t], col_buf[t] = expand_pairs(
            a_ptr, a_idx, a_nnz, None, idx, n_cols=n_cols, flops_pad=step_pad,
            b_row_starts=ptr[:-1], b_row_lens=ptr[1:] - ptr[:-1],
            b_col_base=src * m_per, check_total=False,
        )

    _ring(torch.cat([b_ptr_sh, b_idx_sh]), mesh, expand)
    return _one(*sort_compress(row_buf.reshape(-1), col_buf.reshape(-1), n_rows,
                               n_cols), mesh)


def _flat_tables(tables) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tables])


def _split_tables(flat: torch.Tensor, shapes) -> list:
    out, off = [], 0
    for r, w in shapes:
        out.append(flat[off : off + r * w].view(r, w))
        off += r * w
    return out


def dist_spgemm_ring_ell(tables_sh, entry_rows, entry_pos, *, mesh: RowMesh,
                         rows_pad: int, n_cols: int, widths: tuple[int, ...],
                         ent_pads: tuple[int, ...], step_pad: int) -> Step:
    """Ring-pipelined step with the sliced-ELL expansion: B's class-table
    slices (this rank's ``[tbl_pad_c, w]`` per class, one flat buffer) rotate
    through the group while the rank row-gathers (P3, one launch a step)
    the A-entries whose column falls in the slice it holds.  ``entry_rows``
    / ``entry_pos`` are this rank's ``[S, ent_pad_c]`` per class (dim 0 =
    the source B shard)."""
    from ..ops.ell import _expand_classes

    dev = entry_rows[0].device
    row_buf = torch.empty((mesh.size, step_pad), dtype=INT, device=dev)
    col_buf = torch.empty((mesh.size, step_pad), dtype=INT, device=dev)
    shapes = [tuple(t.shape) for t in tables_sh]

    def expand(t, src, held):
        _expand_classes(
            _split_tables(held, shapes),
            [er[src : src + 1] for er in entry_rows],
            [ep[src : src + 1] for ep in entry_pos],
            widths, ent_pads, (row_buf[t : t + 1], col_buf[t : t + 1]),
            rows_pad=rows_pad, n_cols=n_cols,
        )

    _ring(_flat_tables(tables_sh), mesh, expand)
    return _one(*sort_compress(row_buf.reshape(-1), col_buf.reshape(-1), rows_pad,
                               n_cols), mesh)


def _ell_stream(tables, entry_rows, entry_pos, *, widths, pads, sort_pad: int,
                rows_pad: int, n_cols: int, shift: int | None = None):
    """A rank's ``[C, sort_pad]`` sub-chunk candidate streams: the class
    expansions in class order (one P4 launch with ``shift``, packed keys;
    else one P3 launch, ``(row, col)`` pairs), then sentinel fill — row c
    is the JAX package's ``_ell_expand_chunk`` of sub-chunk c."""
    from ..ops.ell import _expand_classes

    C, dev = entry_rows[0].shape[0], entry_rows[0].device
    kw = dict(rows_pad=rows_pad, n_cols=n_cols, shift=shift)
    if shift is not None:
        key = torch.empty((C, sort_pad), dtype=INT, device=dev)
        off = _expand_classes(tables, entry_rows, entry_pos, widths, pads, key, **kw)
        key[:, off:] = (rows_pad << shift) | n_cols
        return key
    row = torch.empty((C, sort_pad), dtype=INT, device=dev)
    col = torch.empty((C, sort_pad), dtype=INT, device=dev)
    off = _expand_classes(tables, entry_rows, entry_pos, widths, pads, (row, col), **kw)
    row[:, off:] = rows_pad
    col[:, off:] = n_cols
    return row, col


def _gather_tables(tables_sh, mesh: RowMesh) -> list:
    """All-gather B's class-table slices (one collective over the flat
    buffer): per class the gap-padded full table ``[S*tbl_pad_c, w]``."""
    g = comm.all_gather(_flat_tables(tables_sh), mesh)
    out, off = [], 0
    for t in tables_sh:
        r, w = t.shape
        out.append(g[:, off : off + r * w].reshape(-1, w).contiguous())
        off += r * w
    return out


def dist_spgemm_ell(tables, entry_rows, entry_pos, *, mesh: RowMesh, rows_pad: int,
                    n_cols: int, widths: tuple[int, ...], pads: tuple[int, ...],
                    sort_pad: int, gather_tables: bool = False) -> Step:
    """This rank's product with the sliced-ELL expansion over its ``[C,
    pad_c]`` sub-chunk entries: packed keys (P4) sorted by
    :func:`..ops.spgemm.sort_compress_2d_keys` (K1, ``torch.sort`` past its
    window) where ``(rows_pad, n_cols)`` pack, else pairs (P3) through the
    int64 pair sort.  ``gather_tables``: ``tables`` are this rank's B-row
    slices, all-gathered in the step (B memory 1/S until the gather); else
    the replicated tables.  The JAX package's ``batched`` flag changes only
    the plan here: every plan sorts its sub-chunks as one stack."""
    with span("call.dist_spgemm_ell"):
        if gather_tables:
            tables = _gather_tables(tables, mesh)
        kw = dict(widths=widths, pads=pads, sort_pad=sort_pad, rows_pad=rows_pad,
                  n_cols=n_cols)
        packed = packable(rows_pad, n_cols)
        with span("expand"):
            stream = _ell_stream(tables, entry_rows, entry_pos,
                                 shift=n_cols.bit_length() if packed else None, **kw)
        if packed:
            out = sort_compress_2d_keys(stream, rows_pad, n_cols)
        else:
            out = sort_compress_2d(*stream, rows_pad, n_cols)
        return _ptr_fix(*out, mesh)


def dist_masked_spgemm_ell(tables, entry_rows, entry_pos, f_ptr, f_idx, *,
                           mesh: RowMesh, rows_pad: int, n_cols: int,
                           widths: tuple[int, ...], pads: tuple[int, ...],
                           sort_pad: int) -> Step:
    """Masked step with the sliced-ELL expansion: the sub-chunked plan of
    :func:`dist_spgemm_ell` (pairs, P3) with the sort-fused mask join
    replacing the plain compress, every sub-chunk along the last axis at
    once.  ``f_ptr [C, rows_pad+1]``, ``f_idx [C, f_pad]`` chunk-local."""
    from ..ops.spgemm import _row_ids

    row, col = _ell_stream(tables, entry_rows, entry_pos, widths=widths, pads=pads,
                           sort_pad=sort_pad, rows_pad=rows_pad, n_cols=n_cols)
    f_rows = _row_ids(f_ptr, f_idx.shape[-1])
    out = sort_compress_masked(row, col, f_rows, f_idx, f_ptr[:, -1:], rows_pad,
                               n_cols)
    return _ptr_fix(*out, mesh)


def dist_spgemm_or_ell(tables, entry_rows, entry_pos, d_ptr, d_idx, f_ptr=None,
                       f_idx=None, *, mesh: RowMesh, rows_pad: int, n_cols: int,
                       widths: tuple[int, ...], pads: tuple[int, ...],
                       sort_pad: int) -> Step:
    """Fused step C = D OR (F.*?(A·B)) with the sliced-ELL expansion: D's
    chunk-local pairs join each sub-chunk's candidate stream before the sort
    (the SPA pre-seed analogue); with F the three-way tagged join (mask < D
    < candidate) of ``spgemm_or_padded``."""
    from ..ops.ell import _staged_pairs_2d
    from ..ops.fused import _sort_compress_or_masked

    row, col = _ell_stream(tables, entry_rows, entry_pos, widths=widths, pads=pads,
                           sort_pad=sort_pad, rows_pad=rows_pad, n_cols=n_cols)
    d_rows, d_cols = _staged_pairs_2d(d_ptr, d_idx, rows_pad, n_cols)
    if f_ptr is None:
        # D's pairs join the candidate stream; dedup is the union
        out = sort_compress_2d(torch.cat([row, d_rows], -1), torch.cat([col, d_cols], -1),
                               rows_pad, n_cols)
    else:
        f_rows, f_cols = _staged_pairs_2d(f_ptr, f_idx, rows_pad, n_cols)
        out = _sort_compress_or_masked(row, col, d_rows, d_cols, f_rows, f_cols,
                                       rows_pad, n_cols)
    return _ptr_fix(*out, mesh)


# ---------------------------------------------------------------------------
# The counting steps: multiplicities, and the triangles' wedge sum
# ---------------------------------------------------------------------------


def _group_sum(sums: torch.Tensor, mesh: RowMesh) -> int:
    """The group's total of every rank's int32 sums: each widened to int64
    and added on the rank, then one all-reduce.  JAX splits each sum into
    two int32 limbs for its ``psum`` (no int64 there); the total is its
    ``(hi << 15) + lo``."""
    local = sums.to(torch.int64).sum().reshape(1)
    return int(comm.all_reduce_sum(local, mesh)[0])


def dist_spgemm_counts_sharded(a_ptr, a_idx, a_nnz: int, b_ptr, b_idx, *,
                               mesh: RowMesh, n_cols: int, flops_pad: int) -> Step:
    """This rank's ESC counting product: the expansion, then
    :func:`..ops.counts.sort_compress_counts`; each entry's multiplicity is
    the step's counts payload."""
    row, col = expand_pairs(a_ptr, a_idx, a_nnz, b_ptr, b_idx, n_cols=n_cols,
                            flops_pad=flops_pad, check_total=False)
    c_ptr, c_idx, c_cnt, nnz = sort_compress_counts(row, col, a_ptr.shape[0] - 1, n_cols)
    return _one(c_ptr, c_idx, nnz, mesh, c_cnt)


def dist_masked_spgemm_counts_sharded(a_ptr, a_idx, a_nnz: int, f_ptr, f_idx, b_ptr,
                                      b_idx, *, mesh: RowMesh, n_cols: int,
                                      flops_pad: int) -> Step:
    """This rank's masked ESC counting product C = F .* (A·B): the
    expansion, then :func:`..ops.counts.masked_counts_compress` (F
    row-sharded with A).  A rank keeps at most its mask entries, so the
    indices and counts are cut to the mask pad, as JAX's are."""
    row, col = expand_pairs(a_ptr, a_idx, a_nnz, b_ptr, b_idx, n_cols=n_cols,
                            flops_pad=flops_pad, check_total=False)
    f_pad = f_idx.shape[0]
    c_ptr, c_idx, c_cnt, nnz = masked_counts_compress(
        row, col, f_ptr, f_idx, f_ptr[-1], a_ptr.shape[0] - 1, n_cols)
    return _one(c_ptr, c_idx[:f_pad], nnz, mesh, c_cnt[:f_pad])


def dist_triangle_sum_sharded(a_ptr, a_idx, a_nnz: int, f_ptr, f_idx, b_ptr, b_idx, *,
                              mesh: RowMesh, n_cols: int, flops_pad: int) -> int:
    """The group's wedge sum Σ_{(i,j)∈F} mult((A·B)[i,j]), this rank's part
    by the ESC expansion and the tagged counting join
    (:func:`..ops.counts.masked_counts_sum`); every rank returns the total
    (:func:`_group_sum`)."""
    row, col = expand_pairs(a_ptr, a_idx, a_nnz, b_ptr, b_idx, n_cols=n_cols,
                            flops_pad=flops_pad, check_total=False)
    s = masked_counts_sum(row, col, f_ptr, f_idx, f_ptr[-1], a_ptr.shape[0] - 1, n_cols)
    return _group_sum(s, mesh)


def _join_stream(tables, entry_rows, entry_pos, *, rows_pad: int, n_cols: int, **kw):
    """A rank's ``[C, sort_pad]`` stream for a tagged counting join: the
    plain keys ``(row << bl) | col`` (P4) where the join's key, one bit
    wider, packs; else pairs (P3).  Returns ``(row, col, key)``, ``key``
    ``None`` for pairs and ``row``/``col`` ``None`` for keys."""
    kw.update(rows_pad=rows_pad, n_cols=n_cols)
    if packable(rows_pad, 2 * n_cols + 1):
        return None, None, _ell_stream(tables, entry_rows, entry_pos,
                                       shift=n_cols.bit_length(), **kw)
    row, col = _ell_stream(tables, entry_rows, entry_pos, **kw)
    return row, col, None


def dist_spgemm_counts_ell(tables, entry_rows, entry_pos, *, mesh: RowMesh,
                           rows_pad: int, n_cols: int, widths: tuple[int, ...],
                           pads: tuple[int, ...], sort_pad: int) -> Step:
    """This rank's counting product with the sliced-ELL expansion: the
    sub-chunked plan of :func:`dist_spgemm_ell` with the counts compression
    (:func:`..ops.counts.sort_compress_counts`) in place of the plain one,
    every sub-chunk along the last axis at once (packed keys from P4 where
    they pack, the key sort through ``sort_rows``; else P3 pairs and an
    int64 key).  Row c of the step is JAX's sub-chunk c."""
    kw = dict(widths=widths, pads=pads, sort_pad=sort_pad, rows_pad=rows_pad,
              n_cols=n_cols)
    if packable(rows_pad, n_cols):
        key = _ell_stream(tables, entry_rows, entry_pos, shift=n_cols.bit_length(), **kw)
        rows, cols, cnt, nnz = _counts_compress(None, None, rows_pad, n_cols, key=key)
    else:
        rows, cols, cnt, nnz = _counts_compress(
            *_ell_stream(tables, entry_rows, entry_pos, **kw), rows_pad, n_cols)
    return _ptr_fix(_indptr(rows, rows_pad), cols, nnz, mesh, cnt)


def dist_masked_spgemm_counts_ell(tables, entry_rows, entry_pos, f_ptr, f_idx, *,
                                  mesh: RowMesh, rows_pad: int, n_cols: int,
                                  widths: tuple[int, ...], pads: tuple[int, ...],
                                  sort_pad: int) -> Step:
    """This rank's masked counting product with the sliced-ELL expansion
    (per-edge common-neighbour counts when F = A = B): the counts
    compression, then the tagged join with the sub-chunks' mask pairs
    (:func:`..ops.counts._masked_counts`), every sub-chunk at once; indices
    and counts cut to the mask pad.  ``f_ptr [C, rows_pad+1]``, ``f_idx
    [C, f_pad]`` chunk-local."""
    from ..ops.ell import _staged_pairs_2d

    row, col, key = _join_stream(tables, entry_rows, entry_pos, widths=widths, pads=pads,
                                 sort_pad=sort_pad, rows_pad=rows_pad, n_cols=n_cols)
    f_row, f_col = _staged_pairs_2d(f_ptr, f_idx, rows_pad, n_cols)
    cols, rows, cnt, nnz = _masked_counts(row, col, f_row, f_col, rows_pad, n_cols,
                                          seps=False, key=key)
    f_pad = f_idx.shape[-1]
    return _ptr_fix(_indptr(rows, rows_pad), cols[:, :f_pad], nnz, mesh,
                    cnt[:, :f_pad])


def dist_triangle_sum_ell(tables, entry_rows, entry_pos, f_ptr, f_idx, *,
                          mesh: RowMesh, rows_pad: int, n_cols: int,
                          widths: tuple[int, ...], pads: tuple[int, ...],
                          sort_pad: int) -> int:
    """The group's wedge sum with the sliced-ELL expansion: the sub-chunked
    plan of :func:`dist_spgemm_ell` feeding the tagged counting join
    (:func:`..ops.counts._masked_counts_sum`, one int32 a sub-chunk), the
    ELL form of :func:`dist_triangle_sum_sharded`; every rank returns the
    total."""
    from ..ops.ell import _staged_pairs_2d

    row, col, key = _join_stream(tables, entry_rows, entry_pos, widths=widths, pads=pads,
                                 sort_pad=sort_pad, rows_pad=rows_pad, n_cols=n_cols)
    f_row, f_col = _staged_pairs_2d(f_ptr, f_idx, rows_pad, n_cols)
    return _group_sum(_masked_counts_sum(row, col, f_row, f_col, rows_pad, n_cols, key=key),
                      mesh)


# ---------------------------------------------------------------------------
# Assembly: the full result on every rank
# ---------------------------------------------------------------------------


def _assemble(step: Step, sub_bounds: np.ndarray, shape, mesh: RowMesh):
    """Every rank's product gathered into the full ``BCSR`` on every rank
    (the reference's gather-to-root, final/SpGEMM_mpi_omp.c:203-223, made
    symmetric).  Each rank sends only its sub-chunks' valid indices,
    compacted on its device, padded to the longest rank's; the row pointers
    are rebuilt on the host from sub-chunk-local differences of the
    gathered int32 pointers (exact mod 2^32) plus int64 bases, so past 2^31
    output entries the indptr widens to int64.  ``sub_bounds [S, C+1]``.
    A step with a counts payload gathers it as the indices (one more
    gather) and returns ``(BCSR, counts int64)``, the counting ops'
    contract."""
    C = sub_bounds.shape[1] - 1
    rank_nnz = step.counts.sum(1)
    width = int(rank_nnz.max())
    if width == 0:
        return _empty(*shape) if step.cnt is None else _empty_counts(*shape)

    def gathered(x: torch.Tensor) -> np.ndarray:
        mine = x[0] if C == 1 else compact_chunks(x, step.nnz)
        return comm.all_gather_host(mine[:width], mesh).numpy()

    idx = gathered(step.c_idx)
    cnt = None if step.cnt is None else gathered(step.cnt)
    ptr = comm.all_gather_host(step.c_ptr, mesh).numpy()
    indptr_parts = [np.zeros(1, np.int64)]
    index_parts, count_parts = [], []
    base = 0
    for s in range(sub_bounds.shape[0]):
        off = 0
        for c in range(C):
            r0, r1 = sub_bounds[s, c], sub_bounds[s, c + 1]
            n_c = int(step.counts[s, c])
            if r1 > r0:
                index_parts.append(idx[s, off : off + n_c])
                if cnt is not None:
                    count_parts.append(cnt[s, off : off + n_c])
                p = ptr[s, c].view(np.uint32)
                indptr_parts.append((p[1 : r1 - r0 + 1] - p[0]).astype(np.int64) + base)
            base += n_c
            off += n_c
    out = BCSR(np.concatenate(indptr_parts), np.concatenate(index_parts), shape)
    if cnt is None:
        return out
    return out, np.concatenate(count_parts).astype(np.int64)


def _bounds_2d(bounds: np.ndarray) -> np.ndarray:
    """Shard bounds as ``[S, 2]`` sub-chunk bounds (one chunk a shard)."""
    return np.stack([bounds[:-1], bounds[1:]], axis=1)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _ell_plan(a, b, mesh, balance, engine, **kw):
    """The ELL plan of a replicated or sharded product, or ``None`` where it
    does not fit ``AUTO_ELL_MAX_SLOTS`` (or overflows) and ``engine`` is not
    ``"ell"`` (a forced engine surfaces the guard)."""
    from ..ops.ell import AUTO_ELL_MAX_SLOTS

    with span("plan", always=True):
        with span("plan.search", always=True):
            rf = row_flops(a, b)
            bounds = partition_rows(rf, mesh.size, balance=balance)
        try:
            plan = _shard_ell_operands(a, b, mesh.size, bounds, rf, **kw)
        except OverflowError:
            if engine == "ell":
                raise
            return None
    return plan if plan[6] <= AUTO_ELL_MAX_SLOTS or engine == "ell" else None


def _stage_ell(plan, mesh: RowMesh, sharded_tables: bool = False):
    tables, er, ep = plan[:3]
    with span("plan", always=True), span("plan.stage", always=True):
        tables = [(_mine if sharded_tables else _whole)(t, mesh) for t in tables]
        return tables, [_mine(e, mesh) for e in er], [_mine(e, mesh) for e in ep]


def _esc_a(ops: ShardedOperands, mesh: RowMesh) -> tuple:
    """This rank's A shard of an ESC step: ``(ptr, idx, nnz)``."""
    return _mine(ops.a_ptr, mesh), _mine(ops.a_idx, mesh), int(ops.a_nnz[mesh.rank, 0])


def _esc_b(ops: ShardedOperands, mesh: RowMesh) -> tuple:
    """The replicated B of an ESC step: ``(ptr, idx)``."""
    return _whole(ops.b_ptr, mesh), _whole(ops.b_idx, mesh)


def _ell_kw(plan) -> dict:
    widths, pads, rows_pad, sort_pad = plan[3:7]
    return dict(rows_pad=rows_pad, widths=widths, pads=pads, sort_pad=sort_pad)


def dist_spgemm(
    a: BCSR,
    b: BCSR,
    mesh: RowMesh | None = None,
    *,
    balance: str = "flops",
    b_layout: str = "replicated",
    engine: str = "auto",
    device: str | torch.device = "cuda",
) -> BCSR:
    """C = A·B over the ranks of ``mesh`` (this process alone when ``None``,
    on ``device``): every rank calls it with the same operands and gets the
    full result.

    ``engine``: ``"auto"`` takes the sliced-ELL per-shard expansion whenever
    the padded expansion fits (``AUTO_ELL_MAX_SLOTS``) and falls back to
    ESC; ``"esc"`` / ``"ell"`` force one.  ``b_layout``: ``"replicated"``
    keeps the full B on every rank (the reference's semantics);
    ``"sharded"`` row-shards B and all-gathers it in the step;
    ``"ring"`` row-shards B and rotates the shards through the group,
    overlapped with expansion (``O(nnz(B)/S)`` B memory throughout).  Every
    layout has an ELL form."""
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
    if b_layout not in ("replicated", "sharded", "ring"):
        raise ValueError(f"unknown b_layout {b_layout!r}")
    if engine not in ("auto", "esc", "ell"):
        raise ValueError(f"unknown engine {engine!r}")
    require_int32_operands(a, b)
    n, m = a.n_rows, b.n_cols
    if a.nnz == 0 or b.nnz == 0:
        return _empty(n, m)
    mesh = _mesh(mesh, device)

    if engine in ("auto", "ell"):
        from ..ops.ell import AUTO_ELL_MAX_SLOTS

        rf = row_flops(a, b)
        bounds = partition_rows(rf, mesh.size, balance=balance)
        if b_layout == "ring":
            try:
                tbl, er, ep, widths, ent_pads, rows_pad, step_pad = (
                    _shard_ring_ell_operands(a, b, mesh.size, bounds))
                fits = bool(widths) and step_pad * mesh.size <= AUTO_ELL_MAX_SLOTS
            except OverflowError:
                if engine == "ell":
                    raise
                fits = False
            if fits or engine == "ell":
                step = dist_spgemm_ring_ell(
                    [_mine(t, mesh) for t in tbl], [_mine(e, mesh) for e in er],
                    [_mine(e, mesh) for e in ep], mesh=mesh, rows_pad=rows_pad,
                    n_cols=m, widths=widths, ent_pads=ent_pads, step_pad=step_pad)
                return _assemble(step, _bounds_2d(bounds), (n, m), mesh)
        else:
            plan = _ell_plan(a, b, mesh, balance, engine, b_tables=b_layout,
                             allow_batched=True)
            if plan is not None:
                sharded = b_layout == "sharded"
                step = dist_spgemm_ell(*_stage_ell(plan, mesh, sharded), mesh=mesh,
                                       n_cols=m, gather_tables=sharded,
                                       **_ell_kw(plan))
                return _assemble(step, plan[7], (n, m), mesh)

    ops = shard_operands(a, b, mesh.size, balance=balance)
    a_args = _esc_a(ops, mesh)
    if b_layout == "replicated":
        step = dist_spgemm_sharded(*a_args, *_esc_b(ops, mesh), mesh=mesh, n_cols=m,
                                   flops_pad=ops.flops_pad)
    else:
        b_ptr_sh, b_idx_sh, m_per = shard_b_operands(b, mesh.size)
        b_args = (_mine(b_ptr_sh, mesh), _mine(b_idx_sh, mesh))
        if b_layout == "ring":
            step = dist_spgemm_ring(
                *a_args, *b_args, mesh=mesh, n_cols=m, m_per=m_per,
                step_pad=ring_step_pad(a, b, ops.bounds, m_per, mesh.size))
        else:
            step = dist_spgemm_sharded_b(*a_args, *b_args, mesh=mesh, n_cols=m,
                                         flops_pad=ops.flops_pad)
    return _assemble(step, _bounds_2d(ops.bounds), (n, m), mesh)


def dist_masked_spgemm(
    f: BCSR,
    a: BCSR,
    b: BCSR,
    mesh: RowMesh | None = None,
    *,
    balance: str = "flops",
    engine: str = "auto",
    device: str | torch.device = "cuda",
) -> BCSR:
    """C = F .* (A·B) over the ranks of ``mesh`` (≡ SpGEMM_masked under the
    row partition the reference declared but never built,
    final/SpGEMM_mpi_omp.c:229-232).  F (mask FIRST) is canonicalised and
    row-sharded with A; ``engine`` as in :func:`dist_spgemm`."""
    if a.n_cols != b.n_rows or tuple(f.shape) != (a.n_rows, b.n_cols):
        raise ValueError(f"shape mismatch: F{f.shape} vs {a.shape} @ {b.shape}")
    if engine not in ("auto", "esc", "ell"):
        raise ValueError(f"unknown engine {engine!r}")
    require_int32_operands(f, a, b)
    n, m = a.n_rows, b.n_cols
    if a.nnz == 0 or b.nnz == 0 or f.nnz == 0:
        return _empty(n, m)
    f = f.sum_duplicates()
    mesh = _mesh(mesh, device)

    if engine in ("auto", "ell"):
        plan = _ell_plan(a, b, mesh, balance, engine, extra_key_bits=1)
        if plan is not None:
            f_ptr, f_idx = _shard_ell_csr(f, plan[7], plan[5])
            step = dist_masked_spgemm_ell(
                *_stage_ell(plan, mesh), _mine(f_ptr, mesh), _mine(f_idx, mesh),
                mesh=mesh, n_cols=m, **_ell_kw(plan))
            return _assemble(step, plan[7], (n, m), mesh)

    ops = shard_operands(a, b, mesh.size, balance=balance)
    f_ptr, f_idx, _ = _shard_rows_csr(f, ops.bounds, ops.rows_pad)
    step = dist_masked_spgemm_sharded(*_esc_a(ops, mesh), _mine(f_ptr, mesh),
                                      _mine(f_idx, mesh), *_esc_b(ops, mesh), mesh=mesh,
                                      n_cols=m, flops_pad=ops.flops_pad)
    return _assemble(step, _bounds_2d(ops.bounds), (n, m), mesh)


def dist_spm_or(a: BCSR, b: BCSR, mesh: RowMesh | None = None, *,
                device: str | torch.device = "cuda") -> BCSR:
    """C = A OR B over the ranks of ``mesh`` (≡ SpM_OR, old/utils.c:488-504,
    under the row partition): rows split by combined nnz, both operands
    row-sharded, nothing replicated."""
    if tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    require_int32_operands(a, b)
    n, m = a.shape
    mesh = _mesh(mesh, device)
    weights = np.diff(a.indptr).astype(np.int64) + np.diff(b.indptr) + 1
    bounds = partition_rows(weights, mesh.size, balance="flops")
    rows_pad = pad_bucket(int(np.max(np.diff(bounds))) or 1, minimum=1)
    a_ptr, a_idx, a_nnz = _shard_rows_csr(a, bounds, rows_pad)
    b_ptr, b_idx, b_nnz = _shard_rows_csr(b, bounds, rows_pad)
    step = dist_spm_or_sharded(
        _mine(a_ptr, mesh), _mine(a_idx, mesh), int(a_nnz[mesh.rank, 0]),
        _mine(b_ptr, mesh), _mine(b_idx, mesh), int(b_nnz[mesh.rank, 0]),
        mesh=mesh, n_cols=m)
    return _assemble(step, _bounds_2d(bounds), (n, m), mesh)


def dist_spgemm_or(
    d: BCSR,
    a: BCSR,
    b: BCSR,
    mesh: RowMesh | None = None,
    *,
    mask: BCSR | None = None,
    balance: str = "flops",
    engine: str = "auto",
    device: str | torch.device = "cuda",
) -> BCSR:
    """C = D OR (A·B), optionally D OR (mask .* (A·B)), over the ranks of
    ``mesh``: the distributed form of :func:`..ops.fused.spgemm_or` (≡
    SpGEMM_dor / SpGEMM_dor_masked, old/BSpGEMM.c:75-254, which the
    reference only ran single-threaded).  ``engine`` as in
    :func:`dist_spgemm`."""
    if a.n_cols != b.n_rows or tuple(d.shape) != (a.n_rows, b.n_cols):
        raise ValueError(f"shape mismatch: D{d.shape} vs {a.shape} @ {b.shape}")
    if engine not in ("auto", "esc", "ell"):
        raise ValueError(f"unknown engine {engine!r}")
    require_int32_operands(d, a, b)
    n, m = a.n_rows, b.n_cols
    mesh = _mesh(mesh, device)
    if a.nnz == 0 or b.nnz == 0:
        from ..ops.union import spm_or

        return spm_or(d, _empty(n, m), device=mesh.device)
    if mask is not None:
        if tuple(mask.shape) != (n, m):
            raise ValueError(f"mask shape {mask.shape} != {(n, m)}")
        require_int32_operands(mask)
        mask = mask.sum_duplicates()
    d = d.sum_duplicates()

    if engine in ("auto", "ell"):
        plan = _ell_plan(a, b, mesh, balance, engine,
                         extra_key_bits=2 if mask is not None else 0)
        if plan is not None:
            sub_bounds, rows_pad = plan[7], plan[5]
            side = [_mine(x, mesh) for x in _shard_ell_csr(d, sub_bounds, rows_pad)]
            if mask is not None:
                side += [_mine(x, mesh) for x in _shard_ell_csr(mask, sub_bounds,
                                                                rows_pad)]
            step = dist_spgemm_or_ell(*_stage_ell(plan, mesh), *side, mesh=mesh,
                                      n_cols=m, **_ell_kw(plan))
            return _assemble(step, sub_bounds, (n, m), mesh)

    ops = shard_operands(a, b, mesh.size, balance=balance)
    d_ptr, d_idx, d_nnz = _shard_rows_csr(d, ops.bounds, ops.rows_pad)
    side = []
    if mask is not None:
        f_ptr, f_idx, _ = _shard_rows_csr(mask, ops.bounds, ops.rows_pad)
        side = [_mine(f_ptr, mesh), _mine(f_idx, mesh)]
    step = dist_spgemm_or_sharded(
        _mine(d_ptr, mesh), _mine(d_idx, mesh), int(d_nnz[mesh.rank, 0]),
        *_esc_a(ops, mesh), *_esc_b(ops, mesh), *side, mesh=mesh, n_cols=m,
        flops_pad=ops.flops_pad)
    return _assemble(step, _bounds_2d(ops.bounds), (n, m), mesh)


def _counts_route(a, b, mesh, balance, engine, bits, ell_step, esc_step, f=None):
    """The counting ops' routing, as JAX's: the sliced-ELL step where its
    plan fits ``AUTO_ELL_MAX_SLOTS`` (``bits`` the join's extra key bits;
    ``engine="ell"`` forces it and surfaces its guard), else ESC.  ``f``,
    when given, is the mask F, row-sharded with A.  Returns the step's
    result and the sub-chunk bounds ``[S, C+1]`` of its rows."""
    m = b.n_cols
    if engine in ("auto", "ell"):
        plan = _ell_plan(a, b, mesh, balance, engine, extra_key_bits=bits)
        if plan is not None:
            side = () if f is None else tuple(
                _mine(x, mesh) for x in _shard_ell_csr(f, plan[7], plan[5]))
            return ell_step(*_stage_ell(plan, mesh), *side, mesh=mesh, n_cols=m,
                            **_ell_kw(plan)), plan[7]
    ops = shard_operands(a, b, mesh.size, balance=balance)
    side = () if f is None else tuple(
        _mine(x, mesh) for x in _shard_rows_csr(f, ops.bounds, ops.rows_pad)[:2])
    return esc_step(*_esc_a(ops, mesh), *side, *_esc_b(ops, mesh), mesh=mesh, n_cols=m,
                    flops_pad=ops.flops_pad), _bounds_2d(ops.bounds)


def dist_spgemm_counts(
    a: BCSR,
    b: BCSR,
    mesh: RowMesh | None = None,
    *,
    balance: str = "flops",
    engine: str = "auto",
    device: str | torch.device = "cuda",
) -> tuple[BCSR, np.ndarray]:
    """C = A·B with each entry's multiplicity (the integer product of the
    0/1 operands) over the ranks of ``mesh``: the counting form of
    :func:`dist_spgemm` (B replicated, the reference's semantics).  Returns
    ``(c, counts)`` on every rank, ``counts`` int64; ``engine`` as in
    :func:`dist_spgemm`."""
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
    if engine not in ("auto", "esc", "ell"):
        raise ValueError(f"unknown engine {engine!r}")
    require_int32_operands(a, b)
    n, m = a.n_rows, b.n_cols
    if a.nnz == 0 or b.nnz == 0:
        return _empty_counts(n, m)
    # duplicate operand entries would inflate the multiplicities
    a, b = a.sum_duplicates(), b.sum_duplicates()
    mesh = _mesh(mesh, device)
    step, sub_bounds = _counts_route(a, b, mesh, balance, engine, 0,
                                     dist_spgemm_counts_ell, dist_spgemm_counts_sharded)
    return _assemble(step, sub_bounds, (n, m), mesh)


def dist_masked_spgemm_counts(
    f: BCSR,
    a: BCSR,
    b: BCSR,
    mesh: RowMesh | None = None,
    *,
    balance: str = "flops",
    engine: str = "auto",
    device: str | torch.device = "cuda",
) -> tuple[BCSR, np.ndarray]:
    """C = F .* (A·B) with each entry's multiplicity over the ranks of
    ``mesh`` (per-edge common-neighbour counts when f = a = b), the
    distributed :func:`..ops.counts.masked_spgemm_counts`.  MASK FIRST;
    returns ``(c, counts)`` on every rank; ``engine`` as in
    :func:`dist_spgemm`."""
    if a.n_cols != b.n_rows or tuple(f.shape) != (a.n_rows, b.n_cols):
        raise ValueError(f"shape mismatch: F{f.shape} vs {a.shape} @ {b.shape}")
    if engine not in ("auto", "esc", "ell"):
        raise ValueError(f"unknown engine {engine!r}")
    require_int32_operands(f, a, b)
    n, m = a.n_rows, b.n_cols
    if a.nnz == 0 or b.nnz == 0 or f.nnz == 0:
        return _empty_counts(n, m)
    f = f.sum_duplicates()
    a, b = a.sum_duplicates(), b.sum_duplicates()
    mesh = _mesh(mesh, device)
    step, sub_bounds = _counts_route(a, b, mesh, balance, engine, 1,
                                     dist_masked_spgemm_counts_ell,
                                     dist_masked_spgemm_counts_sharded, f)
    return _assemble(step, sub_bounds, (n, m), mesh)


def dist_triangle_count(
    a: BCSR,
    mesh: RowMesh | None = None,
    *,
    balance: str = "flops",
    engine: str = "auto",
    device: str | torch.device = "cuda",
) -> int:
    """Triangles of the undirected simple graph whose (symmetric, hollow)
    adjacency is A, over the ranks of ``mesh``: each rank reduces its row
    block's wedge sum to one int64 and one all-reduce adds them, so no
    index array leaves a rank (the reference gathers the whole result to
    rank 0).  Every rank returns the count.  Raises ``ValueError`` when the
    sum is not divisible by 6; ``engine`` as in :func:`dist_spgemm`."""
    if a.n_rows != a.n_cols:
        raise ValueError("triangles need a square matrix")
    if engine not in ("auto", "esc", "ell"):
        raise ValueError(f"unknown engine {engine!r}")
    require_int32_operands(a)
    if a.nnz == 0:
        return 0
    a = a.sum_duplicates()
    mesh = _mesh(mesh, device)
    total, _ = _counts_route(a, a, mesh, balance, engine, 1, dist_triangle_sum_ell,
                             dist_triangle_sum_sharded, a)
    return _triangles(total)
