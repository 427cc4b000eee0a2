"""Sliced-ELLPACK SpGEMM, batched 2-D form: row-gather expansion + row sorts.

Counterpart of ``binary_spgemm_tpu/ops/ell.py``, the batched slice.  B is laid
out host-side as sliced ELLPACK (rows grouped into width classes, each class
a dense ``[n_rows_c, w_c]`` int32 table padded with the sentinel ``n_cols``);
A's rows are snake-dealt into ``k`` bins; every bin's candidates become one
row of a ``[k, sort_pad]`` packed-key stream

    key = (local_row << shift) | table_c[pos[e]]      # one row-gather per A-entry

plus one separator key per bin row and sentinel fill, and
:func:`..spgemm.sort_compress_seps_2d_keys` sorts, deduplicates and compacts
every row (two K1 launches per dispatch group).  The host splits the
separators off and scatters each bin's rows back to their global positions.

The planner (:func:`_batched_deal_plan`) keeps the JAX package's rate
constants verbatim and takes its off-TPU form (no Pallas-bitonic discount,
no power-of-two ``sort_pad`` rounding), so for the same input both packages
make the same plan, stage the same arrays and sort the same streams.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import torch

from ..formats.bcsr import BCSR
from .spgemm import (
    INT,
    pad_bucket,
    packable,
    pull_chunk_prefixes,
    require_int32_operands,
    resolve_device,
    row_flops,
    sort_compress_seps_2d,
    sort_compress_seps_2d_keys,
    split_seps,
)

__all__ = [
    "EllB",
    "EllSpGEMMExecutor",
    "auto_executor",
    "cached_executor",
    "prefer_batched",
    "width_bucket",
]

# Where the routes this slice does not port are tracked.
_UNROLLED = (
    "the unrolled/dealt sliced-ELL plan is not ported yet "
    "(ROADMAP.md, Queue 1 item 1)"
)
_ESC = (
    "the chunked ESC executor is not ported yet (ROADMAP.md, Queue 1 item 1)"
)


def width_bucket(w: int) -> int:
    """Eighth-octave width class (multiples of 2^(k-3) within each octave)."""
    w = max(int(w), 1)
    p = 1 << (w - 1).bit_length()
    step = max(p // 8, 1)
    return ((w + step - 1) // step) * step


@dataclasses.dataclass
class EllB:
    """Host-built sliced-ELLPACK view of a BCSR matrix.

    ``widths[c]`` is class c's padded row width; ``tables[c]`` is the dense
    ``[n_rows_c, widths[c]]`` int32 index table, sentinel-padded with
    ``n_cols``; ``class_of_row``/``pos_in_class`` map global row id -> class
    and slot.  Empty rows belong to no class (``class_of_row == -1``).
    """

    widths: list[int]
    tables: list[np.ndarray]
    class_of_row: np.ndarray  # int32 [n_rows], -1 for empty rows
    pos_in_class: np.ndarray  # int32 [n_rows]
    shape: tuple[int, int]

    @classmethod
    def build(
        cls, b: BCSR, group_widths: tuple[int, ...] | None = None
    ) -> "EllB":
        """Sliced-ELL layout of B.  ``group_widths`` (ascending) forces each
        row into the smallest listed width >= its own — the planner's merged
        width classes."""
        m = b.n_rows
        w = np.diff(b.indptr).astype(np.int64)
        nz = w > 0
        # vectorised eighth-octave bucket (= width_bucket)
        wb = np.zeros(m, np.int64)
        if nz.any():
            wn = w[nz]
            p = np.left_shift(
                1, np.frexp(wn.astype(np.float64) * 2 - 1)[1] - 1
            )  # smallest power of two >= wn
            step = np.maximum(p // 8, 1)
            wb[nz] = ((wn + step - 1) // step) * step
        if group_widths is not None and nz.any():
            gw = np.asarray(sorted(group_widths), np.int64)
            if wb[nz].max() > gw[-1]:
                raise ValueError(
                    f"group_widths {group_widths} do not cover width "
                    f"{int(wb[nz].max())}"
                )
            wb[nz] = gw[np.searchsorted(gw, wb[nz])]
        classes = np.unique(wb[nz]) if nz.any() else np.zeros(0, np.int64)
        class_of_row = np.full(m, -1, np.int32)
        pos_in_class = np.zeros(m, np.int32)
        widths: list[int] = []
        tables: list[np.ndarray] = []
        sentinel = b.n_cols
        if len(classes):
            # class id + stable in-class slot per nonempty row (slot order
            # within a class = ascending global row)
            rows_nz = np.flatnonzero(nz)
            ci_nz = np.searchsorted(classes, wb[nz]).astype(np.int32)
            class_of_row[rows_nz] = ci_nz
            order = np.argsort(ci_nz.astype(np.int16), kind="stable")
            counts = np.bincount(ci_nz, minlength=len(classes))
            starts = np.concatenate([[0], np.cumsum(counts[:-1])])
            pos_in_class[rows_nz[order]] = (
                np.arange(len(order), dtype=np.int64)
                - np.repeat(starts, counts)
            ).astype(np.int32)
            widths = [int(wc) for wc in classes]
            for ci, wc in enumerate(widths):
                rows = rows_nz[ci_nz == ci]
                # entry e of class row k lands at tbl[k, offset]
                lens = w[rows]
                tbl = np.full((len(rows), wc), sentinel, np.int32)
                dst_row = np.repeat(np.arange(len(rows)), lens)
                dst_off = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
                    np.cumsum(lens) - lens, lens
                )
                src = _segment_sources(b.indptr, rows, lens)
                tbl[dst_row, dst_off] = b.indices[src]
                tables.append(tbl)
        return cls(widths, tables, class_of_row, pos_in_class, tuple(b.shape))


def _segment_sources(
    indptr: np.ndarray, rows: np.ndarray, lens: np.ndarray
) -> np.ndarray:
    """Flat source positions of the CSR segments of ``rows`` (vectorised
    concatenation of ``arange(indptr[r], indptr[r+1])`` over r)."""
    total = int(lens.sum())
    out = np.ones(total, np.int64)
    starts = np.cumsum(lens) - lens
    out[starts] = indptr[rows] - np.concatenate(
        [[0], indptr[rows[:-1]] + lens[:-1] - 1]
    )
    return np.cumsum(out)


def _build_class_entries(
    a: BCSR, ell: EllB
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Partition A's entries by their B-row's width class (host, vectorised).

    Returns per-class ``(entry_rows, entry_pos)``: the output-row id and
    in-class B-row slot of every A-entry whose column belongs to the class.
    Within a class the CSR order (ascending row, file order within a row) is
    kept — the invariant assembly relies on."""
    entry_rows = np.repeat(
        np.arange(a.n_rows, dtype=np.int32), np.diff(a.indptr)
    )
    cls_of_entry = ell.class_of_row[a.indices]
    pos_of_entry = ell.pos_in_class[a.indices]
    # entries whose B row is empty belong to no class and add no flops
    live = cls_of_entry >= 0
    if not live.all():
        entry_rows = entry_rows[live]
        cls_of_entry = cls_of_entry[live]
        pos_of_entry = pos_of_entry[live]
    order = np.argsort(cls_of_entry.astype(np.int16), kind="stable")
    cuts = np.concatenate(
        [[0], np.cumsum(np.bincount(cls_of_entry, minlength=len(ell.widths)))]
    )
    er_s, ep_s = entry_rows[order], pos_of_entry[order]
    rows_per_class = [
        er_s[cuts[ci] : cuts[ci + 1]] for ci in range(len(ell.widths))
    ]
    pos_per_class = [
        ep_s[cuts[ci] : cuts[ci + 1]] for ci in range(len(ell.widths))
    ]
    return rows_per_class, pos_per_class


def _expand_class_2d(
    table: torch.Tensor | None,  # [nc, w] int32, sentinel-padded with n_cols
    entry_rows: torch.Tensor,  # [k, ec_pad] int32, sentinel rows_pad beyond valid
    entry_pos: torch.Tensor,  # [k, ec_pad] or inlined [k, ec_pad*w] int32
    rows_pad: int,
    n_cols: int,
    w: int = 1,
    shift: int | None = None,
):
    """One class's candidates for all k bins: the batched row-gather.

    With ``shift`` returns the packed key stream ``(row << shift) | col``
    (``[k, ec_pad*w]``), invalid slots at the sentinel key
    ``(rows_pad << shift) | n_cols``; else the ``(row, col)`` pair streams
    with invalid slots at ``(rows_pad, n_cols)``."""
    k = entry_rows.shape[0]
    if table is None:  # inlined class: entry_pos IS B's row values
        cols = entry_pos.reshape(k, -1, w)
    else:
        cols = table[entry_pos]  # [k, ec_pad, w] — THE row-gather
    rows = entry_rows[..., None].expand(cols.shape)
    valid = (cols < n_cols) & (rows < rows_pad)
    if shift is not None:
        sentinel = (rows_pad << shift) | n_cols
        key = torch.where(valid, (rows << shift) | cols, sentinel)
        return key.reshape(k, -1)
    rows = torch.where(valid, rows, rows_pad)
    cols = torch.where(valid, cols, n_cols)
    return rows.reshape(k, -1), cols.reshape(k, -1)


def _assemble_stream_2d(
    tables,
    entry_rows,
    entry_pos,
    k: int,
    rows_pad: int,
    n_cols: int,
    widths: tuple[int, ...],
    pads: tuple[int, ...],
    sort_pad: int,
    shift: int | None = None,
):
    """The batched engine's ``[k, sort_pad]`` candidate stream: per-class
    expansions, one ``(r, n_cols)`` separator per bin row, and sentinel fill
    up to ``sort_pad``.  With ``shift``, one packed int32 key array; else the
    ``(row, col)`` pair arrays."""
    device = entry_rows[0].device if entry_rows else None
    fill = sort_pad - (sum(p * w for p, w in zip(pads, widths)) + rows_pad)
    seps = torch.arange(rows_pad, dtype=INT, device=device)
    if shift is not None:
        sentinel = (rows_pad << shift) | n_cols
        parts = [
            _expand_class_2d(t, er, ep, rows_pad, n_cols, w, shift=shift)
            for t, er, ep, w in zip(tables, entry_rows, entry_pos, widths)
        ]
        parts.append(((seps << shift) | n_cols).expand(k, rows_pad))
        if fill:
            parts.append(
                torch.full((k, fill), sentinel, dtype=INT, device=device)
            )
        return torch.cat(parts, dim=1)
    parts_r, parts_c = [], []
    for t, er, ep, w in zip(tables, entry_rows, entry_pos, widths):
        r, c = _expand_class_2d(t, er, ep, rows_pad, n_cols, w)
        parts_r.append(r)
        parts_c.append(c)
    parts_r.append(seps.expand(k, rows_pad))
    parts_c.append(torch.full((k, rows_pad), n_cols, dtype=INT, device=device))
    if fill:
        parts_r.append(torch.full((k, fill), rows_pad, dtype=INT, device=device))
        parts_c.append(torch.full((k, fill), n_cols, dtype=INT, device=device))
    return torch.cat(parts_r, dim=1), torch.cat(parts_c, dim=1)


def _unpack_tables(tables_flat: torch.Tensor, table_shapes) -> tuple:
    """The per-class ELL tables as views of their flat concatenation
    (``None`` for an inlined class, which has no table)."""
    out, off = [], 0
    for shape in table_shapes:
        if shape is None:
            out.append(None)
            continue
        r, w = shape
        out.append(tables_flat[off : off + r * w].view(r, w))
        off += r * w
    return tuple(out)


def _unpack_entries(er_all, ep_all, row0: int, g: int, pads, ep_spans) -> tuple:
    """One dispatch group's bins (rows ``row0 : row0+g``) of the stacked
    entry arrays, split into the class column spans.  ``ep_spans`` differ
    from ``pads`` for inlined classes, whose staged values occupy ``pad*w``
    columns.  Staging keeps ``row0 + g <= k_tot``, so no slice is clamped."""
    er_g = er_all[row0 : row0 + g]
    ep_g = ep_all[row0 : row0 + g]
    ers, eps, off_r, off_p = [], [], 0, 0
    for pad, span in zip(pads, ep_spans):
        ers.append(er_g[:, off_r : off_r + pad])
        eps.append(ep_g[:, off_p : off_p + span])
        off_r += pad
        off_p += span
    return tuple(ers), tuple(eps)


def _ell_spgemm_sep2d(
    tables, entry_rows, entry_pos, *, n_chunks: int, rows_pad: int,
    n_cols: int, widths, pads, sort_pad: int, out_pad: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All bins of one group as ONE ``[n_chunks, sort_pad]`` stream, sorted,
    deduplicated and compacted along axis -1.  Returns the compacted column
    stream (truncated to ``out_pad``) and the per-bin valid counts."""
    if packable(rows_pad, n_cols):
        key = _assemble_stream_2d(
            tables, entry_rows, entry_pos, n_chunks, rows_pad, n_cols,
            widths, pads, sort_pad, shift=int(n_cols).bit_length(),
        )
        idx, nnz = sort_compress_seps_2d_keys(key, rows_pad, n_cols)
    else:
        row, col = _assemble_stream_2d(
            tables, entry_rows, entry_pos, n_chunks, rows_pad, n_cols,
            widths, pads, sort_pad,
        )
        idx, nnz = sort_compress_seps_2d(row, col, rows_pad, n_cols)
    if out_pad is not None and out_pad < sort_pad:
        idx = idx[:, :out_pad]
    return idx, nnz


def _flat_spgemm_sep2d(
    tables_flat, er_all, ep_all, row0: int, *, table_shapes, n_chunks: int,
    rows_pad: int, n_cols: int, widths, pads, sort_pad: int,
    out_pad: int | None = None,
):
    """The flat group runner: unpack the tables and one group's entries from
    the three staged arrays, then run :func:`_ell_spgemm_sep2d`."""
    tables = _unpack_tables(tables_flat, table_shapes)
    ep_spans = tuple(
        p * w if shape is None else p  # inlined: pad*w staged values
        for shape, w, p in zip(table_shapes, widths, pads)
    )
    er, ep = _unpack_entries(er_all, ep_all, row0, n_chunks, pads, ep_spans)
    return _ell_spgemm_sep2d(
        tables, er, ep, n_chunks=n_chunks, rows_pad=rows_pad, n_cols=n_cols,
        widths=widths, pads=pads, sort_pad=sort_pad, out_pad=out_pad,
    )


def _sort_rate_ns(L: int, packed: bool) -> float:
    """Per-element 2-D sort rate by row length (log-linear interpolation of
    the JAX package's measured TPU v5e table, kept verbatim so both
    packages plan alike; not a rate of this port's card)."""
    pts = [(7, 0.05), (9, 0.11), (11, 0.22), (13, 0.36), (16, 0.67),
           (25, 1.43)]
    x = math.log2(max(L, 2))
    if x <= pts[0][0]:
        r = pts[0][1]
    elif x >= pts[-1][0]:
        r = pts[-1][1]
    else:
        for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
            if x0 <= x <= x1:
                r = y0 + (y1 - y0) * (x - x0) / (x1 - x0)
                break
    return r * (1.0 if packed else 1.37)


def _gather_rate_ns(w: int) -> float:
    """Expansion cost per gathered slot by table width (the JAX package's
    TPU calibration, verbatim).  Classes of width <= 2 are inlined at
    staging (no gather at all)."""
    if w <= 2:
        return 0.05
    return 8.5 / w + 0.3


# Per-group constant of the DP class merge (ns per bin), verbatim.
DP_GROUP_NS = 5.0


def _batched_deal_plan(
    a: BCSR,
    b: BCSR,
    rf: np.ndarray,
    cap: int,
    deal_k: int | None,
    key_cols: int,
):
    """Plan the batched 2-D engine: pick the bin count k by the sort-rate
    model, snake-deal rows in dominant-class order, and DP-merge width
    classes so per-bin class pads stop inflating at high k.

    Returns ``None`` when the input is degenerate (no flops), else
    ``(ell, rows_pc, pos_pc, assign, k, pads, slots, rows_pad,
    model_ranking)``."""
    n = a.n_rows
    w = np.diff(b.indptr).astype(np.int64)
    nz = w > 0
    if not nz.any() or a.nnz == 0:
        return None
    # fine eighth-octave width classes (= EllB.build's bucketing), no tables
    wb = np.zeros(b.n_rows, np.int64)
    wn = w[nz]
    p2 = np.left_shift(1, np.frexp(wn.astype(np.float64) * 2 - 1)[1] - 1)
    step = np.maximum(p2 // 8, 1)
    wb[nz] = ((wn + step - 1) // step) * step
    classes = np.unique(wb[nz])
    C = len(classes)
    cls_of_row = np.full(b.n_rows, -1, np.int32)
    cls_of_row[nz] = np.searchsorted(classes, wb[nz]).astype(np.int32)
    # per-fine-class B-row counts -> prefix (prices inlined groups)
    cls_rows_pref = np.zeros(C + 1, np.int64)
    np.cumsum(np.bincount(cls_of_row[nz], minlength=C), out=cls_rows_pref[1:])

    ecls = cls_of_row[a.indices]
    live = ecls >= 0
    rr = np.repeat(
        np.arange(n, dtype=np.int32), np.diff(a.indptr).astype(np.int64)
    )
    ew_full = np.where(live, classes[np.clip(ecls, 0, None)], 0)
    cum = np.zeros(a.nnz + 1, np.int64)
    np.cumsum(ew_full, out=cum[1:])
    rfp = cum[a.indptr[1:]] - cum[a.indptr[:-1]]
    if not int(rfp.sum()):
        return None
    if not live.all():
        ecls = ecls[live]
        rr = rr[live]

    # dominant class per row = class of its widest entry
    dom = np.zeros(n, np.int64)
    nonempty = np.diff(a.indptr) > 0
    if nonempty.any():
        starts = a.indptr[:-1][nonempty]
        maxw = np.maximum.reduceat(ew_full, starts.astype(np.int64))
        dom[nonempty] = np.searchsorted(classes, maxw)
    # one argsort on a composite key = lexsort((-rfp, dom))
    order = np.argsort((dom << 48) - rfp, kind="stable")

    def snake(k):
        pos = np.arange(n, dtype=np.int64)
        if k & (k - 1) == 0:
            lane = (pos & (k - 1)).astype(np.int32)
            fwd = (pos >> k.bit_length() - 1) & 1 == 0
        else:
            lane = (pos % k).astype(np.int32)
            fwd = (pos // k) % 2 == 0
        asg = np.empty(n, np.int32)
        asg[order] = np.where(fwd, lane, k - 1 - lane)
        return asg

    SORT_W = 1.0

    def dp_merge(cnt_pref, k):
        """Optimal contiguous class grouping: min sum of slots x per-slot cost."""
        best = [float("inf")] * (C + 1)
        best[0] = 0.0
        choice = [0] * (C + 1)
        for i in range(1, C + 1):
            w = int(classes[i - 1])
            weight = _gather_rate_ns(w) + SORT_W
            for j in range(i):
                gmax = int((cnt_pref[i] - cnt_pref[j]).max())
                cost = (
                    best[j]
                    + pad_bucket(max(gmax, 8), div=32) * w * weight
                    + DP_GROUP_NS
                )
                if cost < best[i]:
                    best[i] = cost
                    choice[i] = j
        groups = []
        i = C
        while i:
            groups.append((choice[i], i))
            i = choice[i]
        groups.reverse()
        return groups

    def groups_stats(cnt_pref, groups):
        """(padded slots, gather ns/chunk) for a grouping."""
        slots, gather = 0, 0.0
        for j, i in groups:
            w = int(classes[i - 1])
            s = pad_bucket(
                max(int((cnt_pref[i] - cnt_pref[j]).max()), 8), div=32
            ) * w
            slots += s
            rows_g = int(cls_rows_pref[i] - cls_rows_pref[j])
            inl = w <= INLINE_TABLE_W_MAX and rows_g > INLINE_TABLE_ROWS
            rate = 0.05 if inl else 3.2 / w + 0.05
            gather += s * rate
        return slots, gather

    if deal_k:
        ks = [int(deal_k)]
    else:
        k_pack = 1 << max(int(n / max(cap, 1) - 1e-9).bit_length(), 6)
        ks = sorted(
            {
                min(max(k, 64), 1 << 17)
                for k in (
                    k_pack // 4, k_pack // 2, k_pack,
                    2 * k_pack, 4 * k_pack, 8 * k_pack, 16 * k_pack,
                    32 * k_pack, 64 * k_pack, 128 * k_pack, 256 * k_pack,
                )
            }
        )
    ecls64 = ecls.astype(np.int64)

    def eval_k(k, sample_step=1, cliff=False):
        asg = snake(k)
        e, r = (ecls64, rr) if sample_step == 1 else (
            ecls64[::sample_step], rr[::sample_step]
        )
        cnt = np.bincount(e * k + asg[r], minlength=C * k).reshape(C, k)
        pref = np.zeros((C + 1, k), np.int64)
        np.cumsum(cnt, axis=0, out=pref[1:])
        groups = dp_merge(pref, k)
        slots, gather = groups_stats(pref, groups)
        rows_pad = pad_bucket(
            int(np.bincount(asg, minlength=k).max()) or 1, minimum=1, div=32
        )
        L = int(slots) * sample_step + rows_pad
        packed = packable(rows_pad, key_cols)
        BIN_NS = 100.0  # fixed per-bin device cost, verbatim
        Lp = pad_bucket(max(L, 8), div=32)
        p2 = 1 << (Lp - 1).bit_length()
        if cliff:
            # power-of-two cliff pricing: a non-pow2 row costs about
            # rate(next_pow2) * L
            sort_cost = 2.0 * _sort_rate_ns(p2, packed) * L
        else:
            sort_cost = 2.0 * _sort_rate_ns(L, packed) * L
        cost = (sort_cost + gather * sample_step + BIN_NS) * k
        return cost, k, asg, groups, rows_pad, pref

    if len(ks) == 1:
        plans = [eval_k(ks[0])]
        model_ranking = [(plans[0][0], ks[0])]
    else:
        # full resolution up to 2^24 entries, a 1/4 sample beyond
        step = 4 if len(rr) > (1 << 24) else 1
        evals = sorted((eval_k(k, step) for k in ks), key=lambda t: t[0])
        k0 = evals[0][1]
        # re-rank fractional multiples of the coarse winner under cliff
        # pricing (lands sort_pad just under a power of two)
        gran = max(k0 // 8, 32)
        cands = sorted(
            {min(k0 + j * gran, 1 << 17) for j in range(9)}
            | {min(k0 * m // 4, 1 << 17) for m in range(9, 17)}
        )
        refined = sorted(
            (eval_k(kk, step, cliff=True) for kk in cands),
            key=lambda t: t[0],
        )
        model_ranking = [(c, kk) for c, kk, *_ in refined] + [
            (c, kk) for c, kk, *_ in evals if kk not in cands
        ]
        ranked = refined[0]
        plans = [ranked if step == 1 else eval_k(ranked[1], cliff=True)]
    cost, k, assign, groups, rows_pad, pref = plans[0]

    group_widths = tuple(int(classes[i - 1]) for _, i in groups)
    ell = EllB.build(b, group_widths if len(groups) < C else None)
    rows_pc, pos_pc = _build_class_entries(a, ell)
    pads = tuple(
        pad_bucket(int((pref[i] - pref[j]).max()), minimum=8, div=32)
        for j, i in groups
    )
    if len(pads) != len(ell.widths):
        raise RuntimeError(f"plan/table class mismatch: {pads} vs {ell.widths}")
    slots = sum(p * wd for p, wd in zip(pads, ell.widths))
    return ell, rows_pc, pos_pc, assign, k, pads, slots, rows_pad, model_ranking


class EllSpGEMMExecutor:
    """Pre-staged repeated C = A·B via the batched sliced-ELL engine.

    Plans and stages once (host numpy, then three uploads to ``device``);
    each :meth:`run` queues one dispatch per group of bins on the current
    stream and returns the stacked per-bin ``(c_indices, nnz)`` device
    tensors; :meth:`assemble` pulls them and builds the host CSR.

    Only ``batched=True`` is ported: the unrolled plan (``batched=False``,
    and the JAX package's drop to it for degenerate inputs) raises
    ``NotImplementedError``.
    """

    def __init__(
        self,
        a: BCSR,
        b: BCSR,
        *,
        deal_k: int | None = None,
        batched: bool = False,
        batched_slots_cap: int | None = None,
        device: str | torch.device = "cuda",
    ):
        if a.n_cols != b.n_rows:
            raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
        require_int32_operands(a, b)
        if not batched:
            raise NotImplementedError(_UNROLLED)
        self.device = resolve_device(device)
        self.shape = (a.n_rows, b.n_cols)
        self.n_rows, self.n_cols = a.n_rows, b.n_cols
        self.batched = True
        rf = row_flops(a, b)
        # bins stay small enough for the packed sort key to fit one int32
        shift = int(self.n_cols).bit_length()
        cap = 1 << max(0, 30 - shift)
        n = self.n_rows
        planned = _batched_deal_plan(a, b, rf, cap, deal_k, self.n_cols)
        if planned is None:
            raise NotImplementedError(
                "degenerate input (no flops in any bin): " + _UNROLLED
            )
        (ell, rows_pc, pos_pc, assign, k, self.pads, slots, self.rows_pad,
         model_ranking) = planned
        if slots > np.iinfo(np.int32).max:
            raise OverflowError(
                f"batched ELL expansion {slots} slots/bin exceeds int32"
            )
        self.widths = tuple(ell.widths)
        self.k_ranking = list(model_ranking)

        # bins of the snake deal: row sets grouped by bin, ascending row
        # within a bin, and each row's bin-local id
        order2 = np.argsort(assign, kind="stable")
        binsz = np.bincount(assign, minlength=k)
        starts = np.concatenate([[0], np.cumsum(binsz)])
        self.row_sets = [order2[starts[i] : starts[i + 1]] for i in range(k)]
        local_id = np.empty(n, np.int32)
        local_id[order2] = (
            np.arange(n) - np.repeat(starts[:-1], binsz)
        ).astype(np.int32)
        max_chunk_flops = (
            int(np.bincount(assign, weights=rf, minlength=k).max())
            if a.nnz
            else 0
        )
        self.n_chunks = k
        # + rows_pad separator slots per bin; 32nd-octave bucket.  No
        # power-of-two rounding: that rule serves only the TPU's bitonic
        # window, and the plan here is the JAX package's off-TPU plan.
        self.sort_pad = pad_bucket(max(slots + self.rows_pad, 8), div=32)
        self.total_slots = self.sort_pad * k
        if (
            batched_slots_cap is not None
            and self.total_slots > batched_slots_cap
        ):
            raise OverflowError(
                f"batched stream {self.total_slots} slots exceeds the "
                f"auto-route cap {batched_slots_cap}"
            )
        # valid outputs per bin never exceed its true flops + separators
        self.out_pad = min(
            pad_bucket(max_chunk_flops + self.rows_pad), self.sort_pad
        )
        self.resident_slots = self.out_pad * k
        # uniform dispatch groups; the last is padded with all-sentinel
        # dummy bins (assemble() walks only the real ones)
        self.group_size = max(min(k, DISPATCH_SLOT_BUDGET // self.sort_pad), 1)
        if (
            self.total_slots <= SMALL_PLAN_SLOTS
            and self.group_size >= SMALL_PLAN_GROUPS
        ):
            self.group_size = min(self.group_size, -(-k // SMALL_PLAN_GROUPS))
        self.n_groups = -(-k // self.group_size)

        # Flat staging: the tables concatenate into one flat array and the
        # per-(class, bin) entry arrays into one [k_tot, sum(pads)] array
        # each.  Narrow classes (and classes with big tables) are INLINED:
        # the staged entry "position" is B's row values themselves.
        self.inline = tuple(
            w == 1
            or (
                w <= 2
                and len(pos_pc[ci]) * (w - 1) <= ell.tables[ci].shape[0] * w
            )
            or (
                w <= INLINE_TABLE_W_MAX
                and ell.tables[ci].shape[0] > INLINE_TABLE_ROWS
            )
            for ci, w in enumerate(self.widths)
        )
        self.table_shapes = tuple(
            None if inl else t.shape for inl, t in zip(self.inline, ell.tables)
        )
        live_tables = [t for inl, t in zip(self.inline, ell.tables) if not inl]
        tables_flat = (
            np.concatenate([t.reshape(-1) for t in live_tables])
            if live_tables
            else np.zeros(0, np.int32)
        )
        k_tot = self.n_groups * self.group_size
        ep_spans = np.array(
            [
                p * w if inl else p
                for p, w, inl in zip(self.pads, self.widths, self.inline)
            ],
            np.int64,
        )
        P = sum(self.pads)
        P_ep = int(ep_spans.sum())
        offs = np.concatenate([[0], np.cumsum(self.pads)]).astype(np.int64)
        offs_ep = np.concatenate([[0], np.cumsum(ep_spans)]).astype(np.int64)
        er_all = np.full((k_tot, P), self.rows_pad, np.int32)
        ep_all = np.zeros((k_tot, P_ep), np.int32)  # 0: in range of every table
        er_flat, ep_flat = er_all.reshape(-1), ep_all.reshape(-1)
        for ci, (rcls, pcls) in enumerate(zip(rows_pc, pos_pc)):
            ch = assign[rcls]
            ordc = np.argsort(ch, kind="stable")
            cnt = np.bincount(ch, minlength=k)
            cst = np.concatenate([[0], np.cumsum(cnt)])
            rs, ps = rcls[ordc], pcls[ordc]
            rank = np.arange(len(rs), dtype=np.int64) - np.repeat(cst[:-1], cnt)
            er_flat[ch[ordc].astype(np.int64) * P + offs[ci] + rank] = (
                local_id[rs]
            )
            base_ep = ch[ordc].astype(np.int64) * P_ep + offs_ep[ci]
            if self.inline[ci]:
                w = self.widths[ci]
                dst = (base_ep + rank * w)[:, None] + np.arange(w)
                ep_flat[dst.reshape(-1)] = ell.tables[ci][ps].reshape(-1)
            else:
                ep_flat[base_ep + rank] = ps
        self.tables_flat = torch.from_numpy(tables_flat).to(self.device)
        self.er_all = torch.from_numpy(er_all).to(self.device)
        self.ep_all = torch.from_numpy(ep_all).to(self.device)

    def _flat_kw(self):
        return dict(
            table_shapes=self.table_shapes, n_chunks=self.group_size,
            rows_pad=self.rows_pad, n_cols=self.n_cols,
            widths=self.widths, pads=self.pads, sort_pad=self.sort_pad,
        )

    def _row0s(self):
        for gi in range(self.n_groups):
            yield gi * self.group_size

    def run(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Stacked per-bin ``(c_indices [k_tot, out_pad], nnz [k_tot])``
        device tensors, row pointers embedded as ``n_cols`` separators.  One
        dispatch per bin group, all queued on the current stream without a
        host sync; the group outputs concatenate on the device.  Trailing
        dummy bins (sentinel-only) may follow the real ones."""
        outs = [
            _flat_spgemm_sep2d(
                self.tables_flat, self.er_all, self.ep_all, row0,
                **self._flat_kw(), out_pad=self.out_pad,
            )
            for row0 in self._row0s()
        ]
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat([o[i] for o in outs]) for i in range(2))

    def assemble(self, outputs) -> BCSR:
        """Pull :meth:`run`'s outputs and build the host CSR."""
        idx_dev, nnz_dev = outputs
        nnz_c = nnz_dev.cpu().numpy()
        valid = nnz_c.astype(np.int64)
        valid[self.n_chunks :] = 0  # trailing dummy group-fill bins
        chunk_idx = pull_chunk_prefixes(idx_dev, valid)
        if self.n_chunks >= 256:
            # per-bin python splitting costs seconds at thousands of bins:
            # one vectorised pass instead
            return self._assemble_seps_batch(chunk_idx, valid)
        parts = [
            split_seps(chunk_idx[i], int(nnz_c[i]), self.rows_pad, self.n_cols)
            for i in range(self.n_chunks)
        ]
        return self._assemble_parts(parts)

    def _assemble_seps_batch(self, chunk_idx, valid: np.ndarray) -> BCSR:
        """Vectorised host assembly of separator-embedded bin streams: ONE
        pass over the concatenation instead of per-bin ``split_seps``."""
        k = self.n_chunks
        n_rows = self.shape[0]
        big = (
            np.concatenate([chunk_idx[i] for i in range(k)])
            if k
            else np.zeros(0, np.int32)
        )
        nnz_k = valid[:k]
        starts = np.cumsum(nnz_k) - nnz_k
        sep_mask = big == self.n_cols
        bpos = np.flatnonzero(sep_mask)
        if len(bpos) != k * self.rows_pad:
            raise RuntimeError(
                f"separator-count invariant violated: {len(bpos)} separators "
                f"for {k} chunks x rows_pad {self.rows_pad}"
            )
        # per-bin exclusive row pointers off the separator positions
        bpos_k = bpos.reshape(k, self.rows_pad) - starts[:, None]
        ptr_tail = bpos_k - np.arange(self.rows_pad, dtype=np.int64)[None, :]
        lens_kl = np.diff(
            np.concatenate([np.zeros((k, 1), np.int64), ptr_tail], axis=1),
            axis=1,
        )  # [k, rows_pad] per-(bin, local-row) entry counts
        indices_all = big[~sep_mask]  # (bin, ascending local row) order
        rows_concat = np.concatenate(self.row_sets)
        binsz = np.array([len(r) for r in self.row_sets], np.int64)
        real = np.arange(self.rows_pad, dtype=np.int64)[None, :] < binsz[:, None]
        lens_real = lens_kl[real]  # aligned with rows_concat
        lengths = np.zeros(n_rows, np.int64)
        lengths[rows_concat] = lens_real
        indptr = np.concatenate([[0], np.cumsum(lengths)])
        total = int(indptr[-1])
        indices = np.empty(total, np.int32)
        nzm = lens_real > 0
        lr = lens_real[nzm]
        dst = np.repeat(indptr[rows_concat[nzm]], lr) + (
            np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(lr) - lr, lr)
        )
        indices[dst] = indices_all
        return BCSR(indptr, indices, self.shape)

    def _assemble_parts(self, parts) -> BCSR:
        return _stitch_sets(self.row_sets, self.shape[0], self.shape, parts)


def _stitch_sets(row_sets, n_rows: int, shape, parts) -> BCSR:
    """Host assembly for the dealt plan: scatter each bin's row segments back
    to their global rows.  ``parts`` is one ``(c_ptr, c_idx, nnz_c)`` triple
    per bin; bin-local row ids were assigned in ascending global-row order,
    so each bin's compacted stream is already segment-ordered."""
    lengths = np.zeros(n_rows, np.int64)
    for rows, part in zip(row_sets, parts):
        if len(rows):
            cp = np.asarray(part[0][: len(rows) + 1], dtype=np.int64)
            lengths[rows] = np.diff(cp)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    total = int(indptr[-1])
    indices = np.empty(total, np.int32)
    for rows, part in zip(row_sets, parts):
        c_idx = part[1]
        nnz_c = int(part[-1])
        if not nnz_c:
            continue
        lens = lengths[rows]
        nz = lens > 0
        lens = lens[nz]
        dst = np.repeat(indptr[rows[nz]], lens) + (
            np.arange(nnz_c, dtype=np.int64)
            - np.repeat(np.cumsum(lens) - lens, lens)
        )
        indices[dst] = np.asarray(c_idx[:nnz_c])
    return BCSR(indptr, indices, shape)


# Per-dispatch expansion-slot budget (verbatim): larger products run as
# several uniform dispatch groups.
DISPATCH_SLOT_BUDGET = 1 << 27

# Plans within SMALL_PLAN_SLOTS split into about this many dispatch groups
# (verbatim).
SMALL_PLAN_GROUPS = 8
SMALL_PLAN_SLOTS = 1 << 27

# Resident-output budget for choosing ELL over chunked ESC (verbatim).
AUTO_ELL_MAX_SLOTS = 1 << 30

# Tables past this many rows (of width <= INLINE_TABLE_W_MAX) inline their
# referenced values instead of being gathered (verbatim).
INLINE_TABLE_ROWS = 1 << 18
INLINE_TABLE_W_MAX = 16

# Skew guard for the batched plan's resident [k, sort_pad] stream
# (verbatim); over it the JAX package takes the unrolled dealt plan.
BATCHED_MAX_SLOTS = 1 << 28


_EXEC_CACHE: dict = {}
_EXEC_CACHE_MAX = 4
# don't pin staging for huge operands a one-shot caller may never reuse
_EXEC_CACHE_MAX_NNZ = 64 << 20


def cached_executor(
    a: BCSR,
    b: BCSR,
    *,
    allow_bsr: bool = False,
    device: str | torch.device = "cuda",
):
    """A staged executor for C = A·B, cached on operand IDENTITY (checked
    through weakrefs), ``allow_bsr`` and device; FIFO eviction at
    ``_EXEC_CACHE_MAX`` executors, oversized operands never cached.

    ``allow_bsr=True`` lets block-clustered products route to the staged
    blocked engine (:func:`..bsr.maybe_bsr_executor`); only callers that need
    nothing beyond ``assemble(run())`` may pass it, as the one-shot
    ``spgemm`` does.  Otherwise, and where the screen declines, the batched
    sliced-ELL plan serves the product."""
    device = torch.device(device)
    key = (id(a), id(b), allow_bsr, str(device))
    hit = _EXEC_CACHE.get(key)
    if hit is not None:
        wa, wb, ex = hit
        if wa() is a and wb() is b:
            return ex
        del _EXEC_CACHE[key]
    ex = None
    if allow_bsr:
        from .bsr import maybe_bsr_executor

        ex = maybe_bsr_executor(a, b, device=device)
    if ex is None:
        ex = _auto_ell(a, b, device=device)
    if a.nnz + b.nnz <= _EXEC_CACHE_MAX_NNZ:
        while len(_EXEC_CACHE) >= _EXEC_CACHE_MAX:
            _EXEC_CACHE.pop(next(iter(_EXEC_CACHE)))
        _EXEC_CACHE[key] = (weakref.ref(a), weakref.ref(b), ex)
    return ex


def prefer_batched(a: BCSR, b: BCSR) -> bool:
    """Should the plain product use the batched 2-D engine on this input?
    Many rows (>= 2^16, or more than 160 packed chunks' worth) take it;
    fewer take the unrolled plan (not ported)."""
    shift = int(b.n_cols).bit_length()
    cap = 1 << max(0, 30 - shift)
    return a.n_rows > 160 * cap or a.n_rows >= (1 << 16)


def _auto_ell(a: BCSR, b: BCSR, *, device: str | torch.device = "cuda"):
    """The ELL executor the auto path wants: batched 2-D when the many-rows
    rule says so AND the planned stream passes the skew guard.  Where the
    JAX package takes the unrolled plan instead, this raises."""
    if not prefer_batched(a, b):
        raise NotImplementedError(
            "fewer rows than the batched rule takes: " + _UNROLLED
        )
    try:
        return EllSpGEMMExecutor(
            a, b, batched=True, batched_slots_cap=BATCHED_MAX_SLOTS,
            device=device,
        )
    except OverflowError as err:
        raise NotImplementedError(f"{err}: {_UNROLLED}") from err


def auto_executor(a: BCSR, b: BCSR, *, device: str | torch.device = "cuda"):
    """The executor for C = A·B on this input: block-clustered operands take
    the staged blocked engine (:func:`..bsr.maybe_bsr_executor`, a
    ``BsrStagedExecutor``); otherwise the batched sliced-ELL plan when its
    resident output fits ``AUTO_ELL_MAX_SLOTS``.  Every other route of the
    JAX package raises ``NotImplementedError``."""
    from .bsr import maybe_bsr_executor

    bex = maybe_bsr_executor(a, b, device=device)
    if bex is not None:
        return bex
    ex = _auto_ell(a, b, device=device)
    if ex.resident_slots > AUTO_ELL_MAX_SLOTS:
        raise NotImplementedError(
            f"resident output {ex.resident_slots} slots > "
            f"AUTO_ELL_MAX_SLOTS: {_ESC}"
        )
    return ex
