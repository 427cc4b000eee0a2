"""Sliced-ELLPACK SpGEMM: row-gather expansion + row sorts.

Counterpart of ``binary_spgemm_tpu/ops/ell.py``, its plain product in both of
its forms.  B is laid out host-side as sliced ELLPACK (rows grouped into
width classes, each class a dense ``[n_rows_c, w_c]`` int32 table padded
with the sentinel ``n_cols``).  A's rows go into chunks, and every chunk's
candidates ``(local_row, table_c[pos[e]])`` (one row-gather per A-entry,
:mod:`.gather`'s P3/P4), plus one separator per chunk row and sentinel fill,
become one row of a stream that :func:`..spgemm.sort_compress_seps_2d`
sorts, deduplicates and compacts.  The host splits the separators off and
scatters each chunk's rows back to their global positions.

* **Batched** (``batched=True``): ``k`` snake-dealt bins, the stream packed
  as int32 keys ``(row << shift) | col`` by P4 where they fit (pairs by P3
  where not), two K1 launches per dispatch group.
* **Unrolled** (``batched=False``): contiguous flop-balanced chunks or
  snake-dealt ones (``row_chunks``), each chunk's ``(row, col)`` pair stream
  built by P3; one dispatch group's chunks sort as one ``[g, sort_pad]``
  array, each row being the JAX package's 1-D step of that chunk.  Its rows
  run to millions of slots, which :func:`..bitonic.sort_rows` hands to
  ``torch.sort``.

The same streams feed the op family's joins (``run_masked``, ``run_or``,
``run_padded``) and the counting family's compress steps (``run_counts``,
``run_masked_counts``, ``run_counts_sum``, from :mod:`.counts`).

The planners keep the JAX package's rate constants verbatim and take its
off-TPU form (no Pallas-bitonic discount, no power-of-two ``sort_pad``
rounding), so for the same input both packages make the same plan, stage the
same arrays and sort the same streams.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import torch

from .. import native
from ..formats.bcsr import BCSR
from ..utils.timers import bench_fn, event_seconds
from ..utils.trace import span
from .bitonic import sort_rows as sort_rows_1key
from .counts import (
    _masked_counts,
    _masked_counts_sum,
    sort_compress_counts,
    sort_compress_counts_seps_2d,
    sort_compress_counts_seps_2d_keys,
)
from .gather import (
    class_gather,
    class_gather_group,
    class_gather_keys,
    class_gather_keys_group,
)
from .fused import (
    _sort_compress_or_masked,
    _sort_compress_or_masked_seps_2d,
    _sort_compress_or_masked_seps_2d_keys,
)
from .spgemm import (
    INT,
    INT32_MAX,
    _chunk_rows,
    _indptr,
    _prev,
    _row_ids,
    _stitch,
    pad_bucket,
    pad_chunk_csr,
    packable,
    pull_chunk_prefixes,
    require_int32_operands,
    resolve_device,
    row_flops,
    sort_compress_masked_seps_2d,
    sort_compress_masked_seps_2d_keys,
    sort_compress_seps_2d,
    sort_compress_seps_2d_keys,
    split_seps,
)

__all__ = [
    "EllB",
    "EllSpGEMMExecutor",
    "auto_executor",
    "cached_executor",
    "ell_spgemm",
    "prefer_batched",
    "tuned_executor",
    "width_bucket",
]


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
            tables = [np.empty((int(cnt), wc), np.int32)
                      for cnt, wc in zip(counts, widths)]
            # one parallel native pass over B's rows, within its size guard
            if not native.table_fill(b.indptr, b.indices, class_of_row, pos_in_class,
                                     tables, b.n_cols):
                tables = _fill_tables_numpy(b, class_of_row, widths)
        return cls(widths, tables, class_of_row, pos_in_class, tuple(b.shape))


def _fill_tables_numpy(b: BCSR, class_of_row: np.ndarray, widths) -> list[np.ndarray]:
    """The numpy branch of :func:`..native.table_fill`: each class's table,
    its rows in ascending B-row order, sentinel-padded with ``n_cols``."""
    w = np.diff(b.indptr).astype(np.int64)
    tables = []
    for ci, wc in enumerate(widths):
        rows = np.flatnonzero(class_of_row == ci)
        # entry e of class row k lands at tbl[k, offset]
        lens = w[rows]
        tbl = np.full((len(rows), wc), b.n_cols, np.int32)
        dst_row = np.repeat(np.arange(len(rows)), lens)
        dst_off = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(lens) - lens, lens
        )
        src = _segment_sources(b.indptr, rows, lens)
        tbl[dst_row, dst_off] = b.indices[src]
        tables.append(tbl)
    return tables


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
    kept — the invariant assembly relies on.  One parallel native pass
    (:func:`..native.class_partition`) within its size guard, else
    :func:`_class_entries_numpy`."""
    out = native.class_partition(a.indptr, a.indices, ell.class_of_row,
                                 ell.pos_in_class, len(ell.widths))
    return out if out is not None else _class_entries_numpy(a, ell)


def _class_entries_numpy(a: BCSR, ell: EllB) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """The numpy branch of :func:`_build_class_entries`: one stable sort of
    the live entries by class."""
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
    out=None,
    col0: int = 0,
):
    """One class's candidates for all k chunks or bins: the row-gather.

    With ``shift`` the packed key stream ``(row << shift) | col``
    (``[k, ec_pad*w]``), invalid slots at the sentinel key
    ``(rows_pad << shift) | n_cols`` (P4); else the ``(row, col)`` pair
    streams with invalid slots at ``(rows_pad, n_cols)`` (P3).  Given
    ``out`` (the key array, or the ``(row, col)`` pair), the class is written
    into its columns ``col0 : col0 + ec_pad*w`` and ``out`` returned.  An
    inlined class (``table`` None) has no gather: ``entry_pos`` holds B's row
    values themselves, masked and packed by torch ops."""
    if table is not None:
        if shift is not None:
            return class_gather_keys(
                table, entry_pos, entry_rows, rows_pad, n_cols, shift,
                out=out, col0=col0,
            )
        return class_gather(
            table, entry_pos, entry_rows, rows_pad, n_cols, out=out, col0=col0
        )
    k, pad = entry_rows.shape
    cols = entry_pos.reshape(k, pad, w)
    rows = entry_rows[..., None].expand(cols.shape)
    valid = (cols < n_cols) & (rows < rows_pad)
    if shift is not None:
        sentinel = (rows_pad << shift) | n_cols
        res = (torch.where(valid, (rows << shift) | cols, sentinel),)
    else:
        res = (torch.where(valid, rows, rows_pad), torch.where(valid, cols, n_cols))
    res = tuple(x.reshape(k, pad * w) for x in res)
    if out is None:
        return res[0] if shift is not None else res
    span = res[0].shape[1]
    for dst, src in zip((out,) if shift is not None else out, res):
        dst[:, col0 : col0 + span] = src
    return out


def _expand_classes(tables, entry_rows, entry_pos, widths, pads, out, *,
                    rows_pad: int, n_cols: int, shift: int | None = None) -> int:
    """Write every class's expansion into its column span of ``out``, in
    class order from column 0; return the first column past them.  Inlined
    classes are torch ops; the gathered ones go to P4 (with ``shift``) or P3
    together, one launch for the group."""
    gathered, off = [], 0
    for t, er, ep, w, p in zip(tables, entry_rows, entry_pos, widths, pads):
        if t is None:
            _expand_class_2d(None, er, ep, rows_pad, n_cols, w=w, shift=shift,
                             out=out, col0=off)
        else:
            gathered.append((t, ep, er, off))
        off += p * w
    if shift is not None:
        class_gather_keys_group(gathered, rows_pad, n_cols, shift, out)
    else:
        class_gather_group(gathered, rows_pad, n_cols, out)
    return off


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
    extra: tuple = (),
    shift: int | None = None,
    device: torch.device | None = None,
):
    """The batched engine's ``[k, sort_pad]`` candidate stream: per-class
    expansions, the ``extra`` ``(row, col)`` pair blocks (a fused-OR D
    operand), one ``(r, n_cols)`` separator per bin row, and sentinel fill
    up to ``sort_pad``.  With ``shift``, one packed int32 key array; else the
    ``(row, col)`` pair arrays.  Each piece is written in place into its
    column span, so the stream is never concatenated."""
    if device is None:
        device = entry_rows[0].device if entry_rows else None
    seps = torch.arange(rows_pad, dtype=INT, device=device)
    kw = dict(rows_pad=rows_pad, n_cols=n_cols, shift=shift)
    if shift is not None:
        key = torch.empty((k, sort_pad), dtype=INT, device=device)
        off = _expand_classes(tables, entry_rows, entry_pos, widths, pads, key, **kw)
        for er, ec in extra:
            key[:, off : off + er.shape[1]] = (er << shift) | ec
            off += er.shape[1]
        key[:, off : off + rows_pad] = (seps << shift) | n_cols
        key[:, off + rows_pad :] = (rows_pad << shift) | n_cols
        return key
    row = torch.empty((k, sort_pad), dtype=INT, device=device)
    col = torch.empty((k, sort_pad), dtype=INT, device=device)
    off = _expand_classes(
        tables, entry_rows, entry_pos, widths, pads, (row, col), **kw
    )
    for er, ec in extra:
        row[:, off : off + er.shape[1]] = er
        col[:, off : off + er.shape[1]] = ec
        off += er.shape[1]
    row[:, off : off + rows_pad] = seps
    row[:, off + rows_pad :] = rows_pad
    col[:, off:] = n_cols
    return row, col


def _chunk_pair_streams(
    tables,
    entry_rows,  # per-class stacked [n_chunks, pad_c]
    entry_pos,
    *,
    n_chunks: int,
    rows_pad: int,
    n_cols: int,
    widths,
    pads,
    sort_pad: int,
    extra: tuple = (),
    seps: bool = True,
    device: torch.device | None = None,
):
    """The unrolled engine's per-chunk padded candidate ``(row, col)``
    streams, stacked: row i of each ``[n_chunks, sort_pad]`` array is chunk
    i's stream as the JAX package's kernels sort it, its
    ``_chunk_pair_streams`` (class expansions in class order, then ``(rows_pad,
    n_cols)`` fill), then the ``extra`` ``(row, col)`` pair blocks (a
    fused-OR D operand), then, with ``seps``, the chunk's ``rows_pad``
    separators ``(r, n_cols)`` in the last columns."""
    if device is None:
        device = entry_rows[0].device if entry_rows else None
    row = torch.empty((n_chunks, sort_pad), dtype=INT, device=device)
    col = torch.empty((n_chunks, sort_pad), dtype=INT, device=device)
    off = _expand_classes(
        tables, entry_rows, entry_pos, widths, pads, (row, col),
        rows_pad=rows_pad, n_cols=n_cols,
    )
    end = sort_pad - (rows_pad if seps else 0) - sum(er.shape[1] for er, _ in extra)
    row[:, off:end] = rows_pad
    col[:, off:end] = n_cols
    for er, ec in extra:
        row[:, end : end + er.shape[1]] = er
        col[:, end : end + er.shape[1]] = ec
        end += er.shape[1]
    if seps:
        row[:, end:] = torch.arange(rows_pad, dtype=INT, device=device)
        col[:, end:] = n_cols
    return row, col


def _staged_pairs_2d(ptr: torch.Tensor, idx: torch.Tensor, rows_pad: int,
                     n_cols: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sentinel-masked ``(row, col)`` pairs ``[..., P]`` of staged
    chunk-local CSR side operands (a mask, a fused-OR D): ``ptr [...,
    rows_pad + 1]``, ``idx [..., P]``; slots past ``ptr[..., -1]`` become
    ``(rows_pad, n_cols)``.  Row ids by an owner scan along the last axis.
    One chunk's row is the JAX package's ``_staged_pairs``."""
    P = idx.shape[-1]
    rows = _row_ids(ptr, P)
    valid = torch.arange(P, dtype=INT, device=idx.device) < ptr[..., -1:]
    return torch.where(valid, rows, rows_pad), torch.where(valid, idx, n_cols)


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
    """One dispatch group's chunks (rows ``row0 : row0+g``) of the stacked
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


# The device programs, one dispatch group each.  ``tables``, ``entry_rows``
# and ``entry_pos`` are the group's unpacked classes; side operands (a mask F,
# a fused-OR D) arrive as the group's staged ``(ptr, idx)`` rows.


def _ell_spgemm_sep(
    tables, entry_rows, entry_pos, d_ptr=None, d_idx=None, *, n_chunks: int,
    rows_pad: int, n_cols: int, widths, pads, sort_pad: int,
    out_pad: int | None = None, device: torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The unrolled engine on one dispatch group: every chunk's pair stream
    with its separators (``[n_chunks, sort_pad]``), sorted, deduplicated and
    compacted row by row.  Given D (``run_or``, the JAX package's
    ``_ell_or_jit``), D's pairs join each stream before the separators and
    the union is the sort's dedup.  Returns the compacted column streams
    (truncated to ``out_pad``) and the per-chunk valid counts."""
    with span("expand"):
        extra = () if d_ptr is None else (
            _staged_pairs_2d(d_ptr, d_idx, rows_pad, n_cols),)
        row, col = _chunk_pair_streams(
            tables, entry_rows, entry_pos, n_chunks=n_chunks, rows_pad=rows_pad,
            n_cols=n_cols, widths=widths, pads=pads, sort_pad=sort_pad,
            extra=extra, device=device,
        )
    idx, nnz = sort_compress_seps_2d(row, col, rows_pad, n_cols)
    if out_pad is not None and out_pad < sort_pad:
        idx = idx[:, :out_pad]
    return idx, nnz


def _ell_spgemm_sep2d(
    tables, entry_rows, entry_pos, d_ptr=None, d_idx=None, *, n_chunks: int,
    rows_pad: int, n_cols: int, widths, pads, sort_pad: int,
    out_pad: int | None = None, device: torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All bins of one group as ONE ``[n_chunks, sort_pad]`` stream, sorted,
    deduplicated and compacted along axis -1.  Given D (``run_or``, the JAX
    package's ``_ell_or2d_jit``), D's pairs join the stream after the class
    expansions.  Returns the compacted column stream (truncated to
    ``out_pad``) and the per-bin valid counts."""
    args = (tables, entry_rows, entry_pos, n_chunks, rows_pad, n_cols, widths,
            pads, sort_pad)
    packed = packable(rows_pad, n_cols)
    with span("expand"):
        extra = () if d_ptr is None else (
            _staged_pairs_2d(d_ptr, d_idx, rows_pad, n_cols),)
        stream = _assemble_stream_2d(
            *args, extra=extra, shift=int(n_cols).bit_length() if packed else None,
            device=device)
    if packed:
        idx, nnz = sort_compress_seps_2d_keys(stream, rows_pad, n_cols)
    else:
        idx, nnz = sort_compress_seps_2d(*stream, rows_pad, n_cols)
    if out_pad is not None and out_pad < sort_pad:
        idx = idx[:, :out_pad]
    return idx, nnz


def _ell_spgemm_padded2d(
    tables, entry_rows, entry_pos, *, n_chunks: int, rows_pad: int,
    n_cols: int, widths, pads, sort_pad: int, device: torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The one-sort form of :func:`_ell_spgemm_sep2d`: it stops after the
    dedup and demote, returning each bin's sorted packed-key stream with
    ``INT32_MAX`` holes and the per-bin valid counts; the host compacts
    (:meth:`EllSpGEMMExecutor.assemble_padded`).  Batched plans keep their
    keys packed."""
    if not packable(rows_pad, n_cols):
        raise ValueError("run_padded requires packed keys")
    shift = int(n_cols).bit_length()
    key_s = sort_rows_1key(_assemble_stream_2d(
        tables, entry_rows, entry_pos, n_chunks, rows_pad, n_cols, widths,
        pads, sort_pad, shift=shift, device=device,
    ))
    keep = (key_s != _prev(key_s, -1)) & (key_s < (rows_pad << shift))
    return torch.where(keep, key_s, INT32_MAX), keep.sum(1, dtype=INT)


def _ell_masked2d(
    tables, entry_rows, entry_pos, f_ptr, f_idx, *, n_chunks: int,
    rows_pad: int, n_cols: int, widths, pads, sort_pad: int,
    device: torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The batched C = F .* (A·B): the sort-fused mask join over the group's
    stacked ``[k, sort_pad]`` stream (:func:`..spgemm.
    sort_compress_masked_seps_2d`).  A bin's valid entries never exceed its
    mask entries plus its separators, so the output is cut to ``f_pad +
    rows_pad``."""
    f_row, f_col = _staged_pairs_2d(f_ptr, f_idx, rows_pad, n_cols)
    args = (tables, entry_rows, entry_pos, n_chunks, rows_pad, n_cols, widths,
            pads, sort_pad)
    if packable(rows_pad, 2 * n_cols + 1):
        key = _assemble_stream_2d(*args, shift=int(n_cols).bit_length(), device=device)
        idx, nnz = sort_compress_masked_seps_2d_keys(key, f_row, f_col, rows_pad, n_cols)
    else:
        row, col = _assemble_stream_2d(*args, device=device)
        idx, nnz = sort_compress_masked_seps_2d(row, col, f_row, f_col, rows_pad, n_cols)
    return idx[:, : f_idx.shape[-1] + rows_pad], nnz


def _ell_or_masked2d(
    tables, entry_rows, entry_pos, d_ptr, d_idx, f_ptr, f_idx, *, n_chunks: int,
    rows_pad: int, n_cols: int, widths, pads, sort_pad: int,
    device: torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The batched C = D OR (F .* (A·B)): the three-way tagged join (mask <
    D < candidate) along axis -1 with embedded separators
    (:func:`..fused._sort_compress_or_masked_seps_2d`); the output is cut to
    ``d_pad + f_pad + rows_pad``."""
    d_row, d_col = _staged_pairs_2d(d_ptr, d_idx, rows_pad, n_cols)
    f_row, f_col = _staged_pairs_2d(f_ptr, f_idx, rows_pad, n_cols)
    args = (tables, entry_rows, entry_pos, n_chunks, rows_pad, n_cols, widths,
            pads, sort_pad)
    if packable(rows_pad, 4 * n_cols + 3):
        key = _assemble_stream_2d(*args, shift=int(n_cols).bit_length(), device=device)
        idx, nnz = _sort_compress_or_masked_seps_2d_keys(
            key, d_row, d_col, f_row, f_col, rows_pad, n_cols)
    else:
        row, col = _assemble_stream_2d(*args, device=device)
        idx, nnz = _sort_compress_or_masked_seps_2d(
            row, col, d_row, d_col, f_row, f_col, rows_pad, n_cols)
    return idx[:, : d_idx.shape[-1] + f_idx.shape[-1] + rows_pad], nnz


def _ell_masked(
    tables, entry_rows, entry_pos, f_ptr, f_idx, *, n_chunks: int,
    rows_pad: int, n_cols: int, widths, pads, sort_pad: int,
    device: torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The unrolled C = F .* (A·B): each chunk's separator-embedded pair
    stream joined with its mask pairs (:func:`..spgemm.
    sort_compress_masked_seps_2d`, a row per chunk).  Returns ``(indices
    [n_chunks, sort_pad + f_pad], nnz)``."""
    row, col = _chunk_pair_streams(
        tables, entry_rows, entry_pos, n_chunks=n_chunks, rows_pad=rows_pad,
        n_cols=n_cols, widths=widths, pads=pads, sort_pad=sort_pad, device=device,
    )
    f_row, f_col = _staged_pairs_2d(f_ptr, f_idx, rows_pad, n_cols)
    return sort_compress_masked_seps_2d(row, col, f_row, f_col, rows_pad, n_cols)


def _ell_or_masked(
    tables, entry_rows, entry_pos, d_ptr, d_idx, f_ptr, f_idx, *, n_chunks: int,
    rows_pad: int, n_cols: int, widths, pads, sort_pad: int,
    device: torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unrolled C = D OR (F .* (A·B)): each chunk's pair stream without
    separators (a 2-bit tag leaves no room for them there, as in the JAX
    package) through the three-way join (:func:`..fused.
    _sort_compress_or_masked`, a row per chunk).  Returns chunk-local
    ``(indptr [n_chunks, rows_pad + 1], indices, nnz)``."""
    row, col = _chunk_pair_streams(
        tables, entry_rows, entry_pos, n_chunks=n_chunks, rows_pad=rows_pad,
        n_cols=n_cols, widths=widths, pads=pads, sort_pad=sort_pad, seps=False,
        device=device,
    )
    d_row, d_col = _staged_pairs_2d(d_ptr, d_idx, rows_pad, n_cols)
    f_row, f_col = _staged_pairs_2d(f_ptr, f_idx, rows_pad, n_cols)
    return _sort_compress_or_masked(row, col, d_row, d_col, f_row, f_col,
                                    rows_pad, n_cols)


def _ell_counts2d(
    tables, entry_rows, entry_pos, *, n_chunks: int, rows_pad: int, n_cols: int,
    widths, pads, sort_pad: int, out_pad: int | None = None,
    device: torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batched counting product: the group's ``[k, sort_pad]`` stream
    through :func:`..counts.sort_compress_counts_seps_2d(_keys)`, the counts
    riding the compaction sort.  Returns separator-embedded ``(indices,
    counts, nnz)``, truncated to ``out_pad``; the host drops each
    separator's count with it."""
    args = (tables, entry_rows, entry_pos, n_chunks, rows_pad, n_cols, widths,
            pads, sort_pad)
    if packable(rows_pad, n_cols):
        key = _assemble_stream_2d(*args, shift=int(n_cols).bit_length(), device=device)
        idx, cnt, nnz = sort_compress_counts_seps_2d_keys(key, rows_pad, n_cols)
    else:
        row, col = _assemble_stream_2d(*args, device=device)
        idx, cnt, nnz = sort_compress_counts_seps_2d(row, col, rows_pad, n_cols)
    if out_pad is not None and out_pad < sort_pad:
        idx, cnt = idx[:, :out_pad], cnt[:, :out_pad]
    return idx, cnt, nnz


def _masked_stream_2d(tables, entry_rows, entry_pos, f_ptr, f_idx, *, n_chunks: int,
                      rows_pad: int, n_cols: int, widths, pads, sort_pad: int,
                      device: torch.device | None = None):
    """The batched masked plan's inputs to a counting join: ``(row, col, key,
    f_row, f_col)``, the group's stream as packed plain keys ``key`` where
    ``packable(rows_pad, 2 * n_cols + 1)`` (``row``/``col`` None), else as
    the ``(row, col)`` pairs (``key`` None), and the staged mask's pairs."""
    f_row, f_col = _staged_pairs_2d(f_ptr, f_idx, rows_pad, n_cols)
    args = (tables, entry_rows, entry_pos, n_chunks, rows_pad, n_cols, widths,
            pads, sort_pad)
    if packable(rows_pad, 2 * n_cols + 1):
        key = _assemble_stream_2d(*args, shift=int(n_cols).bit_length(), device=device)
        return None, None, key, f_row, f_col
    row, col = _assemble_stream_2d(*args, device=device)
    return row, col, None, f_row, f_col


def _ell_masked_counts2d(tables, entry_rows, entry_pos, f_ptr, f_idx, **kw):
    """The batched C = F .* (A·B) with counts
    (:func:`..counts._masked_counts` with separators over the group's
    stream); the outputs are cut to ``f_pad + rows_pad``."""
    row, col, key, f_row, f_col = _masked_stream_2d(
        tables, entry_rows, entry_pos, f_ptr, f_idx, **kw)
    idx, _, cnt, nnz = _masked_counts(row, col, f_row, f_col, kw["rows_pad"],
                                      kw["n_cols"], seps=True, key=key)
    cut = f_idx.shape[-1] + kw["rows_pad"]
    return idx[:, :cut], cnt[:, :cut], nnz


def _ell_counts_sum2d(tables, entry_rows, entry_pos, f_ptr, f_idx, **kw):
    """The batched masked counts sum: one int32 per bin
    (:func:`..counts._masked_counts_sum` over the group's stream, whose
    separators match no mask pair)."""
    with span("expand"):
        row, col, key, f_row, f_col = _masked_stream_2d(
            tables, entry_rows, entry_pos, f_ptr, f_idx, **kw)
    return _masked_counts_sum(row, col, f_row, f_col, kw["rows_pad"], kw["n_cols"],
                              key=key)


# The unrolled counting programs sort each chunk's stream without
# separators, as the JAX package's do (the counts payload already pays the
# extra sort lane): ``_chunk_pair_streams(seps=False)``.


def _ell_counts(tables, entry_rows, entry_pos, *, out_pad: int | None = None, **kw):
    """The unrolled counting product: each chunk's stream through
    :func:`..counts.sort_compress_counts`, a row per chunk.  Returns
    chunk-local ``(indptr [n_chunks, rows_pad + 1], indices, counts, nnz)``,
    the last three cut to ``out_pad``."""
    row, col = _chunk_pair_streams(tables, entry_rows, entry_pos, seps=False, **kw)
    ptr, idx, cnt, nnz = sort_compress_counts(row, col, kw["rows_pad"], kw["n_cols"])
    if out_pad is not None and out_pad < kw["sort_pad"]:
        idx, cnt = idx[:, :out_pad], cnt[:, :out_pad]
    return ptr, idx, cnt, nnz


def _ell_masked_counts(tables, entry_rows, entry_pos, f_ptr, f_idx, **kw):
    """The unrolled C = F .* (A·B) with counts: each chunk's stream joined
    with its mask pairs (:func:`..counts._masked_counts`, a row per chunk).
    Returns chunk-local ``(indptr, indices, counts, nnz)``, the middle two
    cut to the mask pad (a chunk keeps at most its mask entries)."""
    row, col = _chunk_pair_streams(tables, entry_rows, entry_pos, seps=False, **kw)
    rows_pad, n_cols = kw["rows_pad"], kw["n_cols"]
    f_row, f_col = _staged_pairs_2d(f_ptr, f_idx, rows_pad, n_cols)
    idx, rows, cnt, nnz = _masked_counts(row, col, f_row, f_col, rows_pad, n_cols,
                                         seps=False)
    f_pad = f_idx.shape[-1]
    return _indptr(rows, rows_pad), idx[:, :f_pad], cnt[:, :f_pad], nnz


def _ell_counts_sum(tables, entry_rows, entry_pos, f_ptr, f_idx, **kw):
    """The unrolled masked counts sum: one int32 per chunk."""
    with span("expand"):
        row, col = _chunk_pair_streams(tables, entry_rows, entry_pos, seps=False, **kw)
        f_row, f_col = _staged_pairs_2d(f_ptr, f_idx, kw["rows_pad"], kw["n_cols"])
    return _masked_counts_sum(row, col, f_row, f_col, kw["rows_pad"], kw["n_cols"])


def _make_flat_kernel(inner):
    """A flat group runner around ``inner``: unpack the tables and one
    group's entries from the three staged arrays, slice the group's rows of
    the staged side operands (``extra_arrays``), then run ``inner`` on the
    staged arrays' device."""

    def runner(
        tables_flat, er_all, ep_all, row0: int, *extra_arrays, table_shapes,
        n_chunks: int, rows_pad: int, n_cols: int, widths, pads,
        sort_pad: int, **kw,
    ):
        tables = _unpack_tables(tables_flat, table_shapes)
        ep_spans = tuple(
            p * w if shape is None else p  # inlined: pad*w staged values
            for shape, w, p in zip(table_shapes, widths, pads)
        )
        er, ep = _unpack_entries(er_all, ep_all, row0, n_chunks, pads, ep_spans)
        extras = tuple(m[row0 : row0 + n_chunks] for m in extra_arrays)
        return inner(
            tables, er, ep, *extras, n_chunks=n_chunks, rows_pad=rows_pad,
            n_cols=n_cols, widths=widths, pads=pads, sort_pad=sort_pad,
            device=er_all.device, **kw,
        )

    return runner


_flat_spgemm_sep = _make_flat_kernel(_ell_spgemm_sep)
_flat_spgemm_sep2d = _make_flat_kernel(_ell_spgemm_sep2d)
_flat_spgemm_padded2d = _make_flat_kernel(_ell_spgemm_padded2d)
_flat_masked = _make_flat_kernel(_ell_masked)
_flat_masked2d = _make_flat_kernel(_ell_masked2d)
_flat_or_masked = _make_flat_kernel(_ell_or_masked)
_flat_or_masked2d = _make_flat_kernel(_ell_or_masked2d)
_flat_counts = _make_flat_kernel(_ell_counts)
_flat_counts2d = _make_flat_kernel(_ell_counts2d)
_flat_masked_counts = _make_flat_kernel(_ell_masked_counts)
_flat_masked_counts2d = _make_flat_kernel(_ell_masked_counts2d)
_flat_counts_sum = _make_flat_kernel(_ell_counts_sum)
_flat_counts_sum2d = _make_flat_kernel(_ell_counts_sum2d)


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
    merge_widths: tuple[int, ...] | None = None,
    discount_sorts: bool = True,
):
    """Plan the batched 2-D engine: pick the bin count k by the sort-rate
    model, snake-deal rows in dominant-class order, and DP-merge width
    classes so per-bin class pads stop inflating at high k (or group them at
    the caller's ``merge_widths`` levels).

    ``discount_sorts=False`` is how the masked and fused family plans in the
    JAX package, TPU or not: gathered classes priced at ``_gather_rate_ns``
    instead of the plain family's fused rate, and no power-of-two cliff
    refinement of the coarse pick (the family's streams are longer than
    ``sort_pad``).  Its other effect there, the bitonic discount, needs a
    TPU and so never applies to this package's plans.

    Returns ``None`` when the input is degenerate (no flops), else
    ``(ell, rows_pc, pos_pc, assign, k, pads, slots, rows_pad,
    model_ranking)``."""
    with span("plan.search", always=True):
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

        def forced_groups(gw):
            """Contiguous class grouping at caller-forced width levels."""
            gw = sorted(int(x) for x in gw)
            if gw[-1] < int(classes[-1]):
                raise ValueError(
                    f"merge_widths {gw} do not cover max class {classes[-1]}"
                )
            groups, j = [], 0
            for lvl in gw:
                i = int(np.searchsorted(classes, lvl, side="right"))
                if i > j:
                    groups.append((j, i))
                    j = i
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
                if inl:
                    rate = 0.05
                elif discount_sorts:
                    rate = 3.2 / w + 0.05  # the plain family's fused rate
                else:
                    rate = _gather_rate_ns(w)
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
            groups = (
                forced_groups(merge_widths)
                if merge_widths is not None
                else dp_merge(pref, k)
            )
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
        elif not discount_sorts:
            step = 4 if len(rr) > (1 << 24) else 1
            evals = sorted((eval_k(k, step) for k in ks), key=lambda t: t[0])
            model_ranking = [(c, kk) for c, kk, *_ in evals]
            plans = [evals[0] if step == 1 else eval_k(evals[0][1])]
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

    with span("plan.tables", always=True):
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
    """Pre-staged repeated C = A·B via the sliced-ELL engine.

    Plans and stages once (host numpy, then three uploads to ``device``);
    each :meth:`run` queues one dispatch per group of chunks on the current
    stream and returns the stacked per-chunk ``(c_indices, nnz)`` device
    tensors; :meth:`assemble` pulls them and builds the host CSR.

    ``batched=True`` takes the batched 2-D plan (:func:`_batched_deal_plan`;
    a degenerate input with no flops drops to the unrolled plan, as in the
    JAX package).  Otherwise the unrolled plan: ``row_chunks`` is ``"auto"``
    (about 32 padded-slot-balanced contiguous chunks, capped for the packed
    key when that does not inflate the padding, or the snake deal when its
    sort cost is below 0.9 of theirs), ``"contig"``, ``"deal"``, ``1`` or a
    chunk count; ``deal_k`` forces a deal into that many bins.

    ``masked=True`` plans for the op family (:meth:`run_masked`,
    :meth:`run_or`): the mask join packs ``(row, col, tag)``, one more low
    bit, so the chunk row cap halves and the batched plan is the JAX
    package's masked one (``discount_sorts=False``).  Every executor serves
    every ``run_*`` method; the plan only decides which keys stay packed.
    """

    def __init__(
        self,
        a: BCSR,
        b: BCSR,
        *,
        row_chunks: int | str = "auto",
        masked: bool = False,
        deal_k: int | None = None,
        batched: bool = False,
        merge_widths: tuple[int, ...] | None = None,
        batched_slots_cap: int | None = None,
        device: str | torch.device = "cuda",
    ):
        with span("plan", always=True):
            if a.n_cols != b.n_rows:
                raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
            require_int32_operands(a, b)
            self.device = resolve_device(device)
            self.shape = (a.n_rows, b.n_cols)
            self.n_rows, self.n_cols = a.n_rows, b.n_cols
            with span("plan.search", always=True):
                rf = row_flops(a, b)
            # chunks stay small enough for the packed sort key to fit one int32;
            # a mask-serving plan packs one more (tag) bit
            shift = int(self.n_cols).bit_length() + (1 if masked else 0)
            cap = 1 << max(0, 30 - shift)
            n = self.n_rows
            key_cols = 2 * self.n_cols + 1 if masked else self.n_cols
            self.batched = bool(batched)
            dealt = None
            if batched:
                planned = _batched_deal_plan(
                    a, b, rf, cap, deal_k, key_cols, merge_widths=merge_widths,
                    discount_sorts=not masked,
                )
                if planned is None:
                    self.batched = False  # degenerate input: unrolled is fine
                else:
                    (ell, rows_pc, pos_pc, assign, k_d, pads_d, slots_d,
                     rows_pad_d, model_ranking) = planned
                    if slots_d > np.iinfo(np.int32).max:
                        raise OverflowError(
                            f"batched ELL expansion {slots_d} slots/bin "
                            "exceeds int32"
                        )
                    dealt = (assign, k_d, pads_d, slots_d, rows_pad_d)
                    self.widths = tuple(ell.widths)
                    self.k_ranking = list(model_ranking)
            if dealt is None:
                with span("plan.tables", always=True):
                    ell = EllB.build(b)
                    rows_pc, pos_pc = _build_class_entries(a, ell)
                self.widths = tuple(ell.widths)
            with span("plan.search", always=True):
                # balance chunks on padded expansion slots: per-row weight = sum over
                # its entries of the B-row's class width
                padded_w = np.zeros(len(ell.widths) + 1, np.int64)
                for ci, wc in enumerate(ell.widths):
                    padded_w[ci] = wc
                rfp = np.zeros(a.n_rows, np.int64)
                if a.nnz:
                    entry_w = padded_w[ell.class_of_row[a.indices]]
                    cum = np.zeros(a.nnz + 1, np.int64)
                    np.cumsum(entry_w, out=cum[1:])
                    rfp = cum[a.indptr[1:]] - cum[a.indptr[:-1]]
                total_flops = int(rfp.sum())

                def plan(bounds):
                    """A contiguous chunk plan's per-class cuts and pads, padded
                    slots per chunk and in all."""
                    k = len(bounds) - 1
                    cuts_pc, pads = [], []
                    for rcls in rows_pc:
                        cuts = np.searchsorted(rcls, np.asarray(bounds))
                        cuts_pc.append(cuts)
                        pads.append(
                            pad_bucket(max(int(np.diff(cuts).max()), 1), minimum=8)
                        )
                    slots = sum(p * w for p, w in zip(pads, self.widths))
                    return cuts_pc, tuple(pads), slots, slots * k

                force = row_chunks if isinstance(row_chunks, str) else None
                if force in ("auto", "contig", "deal"):
                    # ~32 slot-balanced chunks; the packed-key row cap is kept only
                    # when its padded total stays within 2x the uncapped plan's
                    budget = max(total_flops // 32, 1 << 19)
                    bounds = _chunk_bounds(rfp, budget, max(n, 1))
                    if cap >= 512 and -(-n // cap) <= 160:
                        capped = _chunk_bounds(rfp, budget, cap)
                        if len(capped) > len(bounds):
                            _, _, _, tot_c = plan(capped)
                            _, _, _, tot_u = plan(bounds)
                            if tot_c <= 2 * tot_u:
                                bounds = capped
                elif row_chunks == 1:
                    bounds = [0, n]
                else:
                    budget = max(total_flops // int(row_chunks), 1)
                    bounds = _chunk_bounds(rfp, budget, -(-n // int(row_chunks)))
                chunks_c = list(zip(bounds, bounds[1:]))
                rows_pad_c = pad_bucket(
                    max(r1 - r0 for r0, r1 in chunks_c) if n else 1, minimum=1
                )
                cuts_pc, pads_c, slots_c, _ = plan(bounds)

                # dealt plan: rows snake-dealt into k_d bins by descending padded
                # weight, which evens every class's per-bin counts at once
                if dealt is None and (
                    force in ("auto", "deal") or deal_k
                ) and n > 0 and self.widths and total_flops:
                    if deal_k:
                        k_d = int(deal_k)
                    else:
                        m_pack = -(-n // cap) if cap >= 512 else 257
                        k_d = max(32, min(2 * m_pack, 256)) if m_pack <= 256 else 48
                    order = np.argsort(-rfp, kind="stable")
                    pos = np.arange(n)
                    lane = (pos % k_d).astype(np.int32)
                    assign = np.empty(n, np.int32)
                    assign[order] = np.where((pos // k_d) % 2 == 0, lane, k_d - 1 - lane)

                    def eval_assign(asg):
                        pads = tuple(
                            pad_bucket(
                                int(np.bincount(asg[rcls], minlength=k_d).max())
                                if len(rcls)
                                else 1,
                                minimum=8,
                            )
                            for rcls in rows_pc
                        )
                        slots = sum(p * w for p, w in zip(pads, self.widths))
                        rp = pad_bucket(
                            int(np.bincount(asg, minlength=k_d).max()) or 1, minimum=1
                        )
                        return pads, slots, rp

                    pads_d, slots_d, rows_pad_d = eval_assign(assign)
                    if slots_d <= np.iinfo(np.int32).max:
                        dealt = (assign, k_d, pads_d, slots_d, rows_pad_d)

                def sort_cost(slots, k, rows_pad):
                    # the JAX package's relative weight of an unpacked 2-key sort
                    rate = 1.0 if packable(rows_pad, key_cols) else 1.36
                    return pad_bucket(max(slots, 8)) * k * rate

                use_dealt = (
                    self.batched or force == "deal" or deal_k is not None
                ) and dealt is not None
                if (
                    force == "auto" and deal_k is None and not self.batched
                ) and dealt is not None:
                    assign, k_d, pads_d, slots_d, rows_pad_d = dealt
                    use_dealt = sort_cost(slots_d, k_d, rows_pad_d) < 0.9 * sort_cost(
                        slots_c, len(chunks_c), rows_pad_c
                    )

                if use_dealt:
                    assign, k, self.pads, slots, self.rows_pad = dealt
                    self.chunks = None
                    self.bounds = None
                    # bins grouped by bin, ascending row within a bin, and each row's
                    # bin-local id
                    order2 = np.argsort(assign, kind="stable")
                    binsz = np.bincount(assign, minlength=k)
                    starts = np.concatenate([[0], np.cumsum(binsz)])
                    self.row_sets = [
                        order2[starts[i] : starts[i + 1]] for i in range(k)
                    ]
                    self._assign = assign  # each row's bin, for staged_nnz_pad
                    local_id = np.empty(n, np.int32)
                    local_id[order2] = (
                        np.arange(n) - np.repeat(starts[:-1], binsz)
                    ).astype(np.int32)
                    max_chunk_flops = (
                        int(np.bincount(assign, weights=rf, minlength=k).max())
                        if a.nnz
                        else 0
                    )
                else:
                    self.bounds = np.asarray(bounds, np.int64)
                    self.chunks = chunks_c
                    self.row_sets = None
                    self.rows_pad = rows_pad_c
                    self.pads = pads_c
                    slots = slots_c
                    k = len(chunks_c)
                    max_chunk_flops = max(
                        (int(rf[r0:r1].sum()) for r0, r1 in chunks_c), default=0
                    )
                self.n_chunks = k
                if slots > np.iinfo(np.int32).max:
                    raise OverflowError(
                        f"ELL chunk expansion {slots} slots exceeds int32; "
                        "use the chunked ESC engine for this product"
                    )
                # + rows_pad separator slots per chunk; 32nd-octave bucket.  No
                # power-of-two rounding: that rule serves only the TPU's bitonic
                # window, and the plan here is the JAX package's off-TPU plan.
                self.sort_pad = pad_bucket(max(slots + self.rows_pad, 8), div=32)
                self.total_slots = self.sort_pad * k
                if (
                    self.batched
                    and batched_slots_cap is not None
                    and self.total_slots > batched_slots_cap
                ):
                    raise OverflowError(
                        f"batched stream {self.total_slots} slots exceeds the "
                        f"auto-route cap {batched_slots_cap}"
                    )
                # valid outputs per chunk never exceed its true flops + separators
                self.out_pad = min(
                    pad_bucket(max_chunk_flops + self.rows_pad), self.sort_pad
                )
                self.resident_slots = self.out_pad * k
                # uniform dispatch groups; the last is padded with all-sentinel
                # dummy chunks (assemble() walks only the real ones)
                self.group_size = max(min(k, DISPATCH_SLOT_BUDGET // self.sort_pad), 1)
                if (
                    self.batched
                    and self.total_slots <= SMALL_PLAN_SLOTS
                    and self.group_size >= SMALL_PLAN_GROUPS
                ):
                    self.group_size = min(self.group_size, -(-k // SMALL_PLAN_GROUPS))
                self.n_groups = -(-k // self.group_size)

            with span("plan.stage", always=True):
                # Flat staging: the tables concatenate into one flat array and the
                # per-(class, chunk) entry arrays into one [k_tot, sum(pads)] array
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
                if self.row_sets is not None:
                    # per-class partition of A's entries by dealt chunk; within a
                    # chunk entries keep ascending global-row order (local_id)
                    er_flat, ep_flat = er_all.reshape(-1), ep_all.reshape(-1)
                    for ci, (rcls, pcls) in enumerate(zip(rows_pc, pos_pc)):
                        ch = assign[rcls]
                        ordc = np.argsort(ch, kind="stable")
                        cnt = np.bincount(ch, minlength=k)
                        cst = np.concatenate([[0], np.cumsum(cnt)])
                        rs, ps = rcls[ordc], pcls[ordc]
                        rank = np.arange(len(rs), dtype=np.int64) - np.repeat(
                            cst[:-1], cnt
                        )
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
                else:
                    for ci, (rcls, pcls) in enumerate(zip(rows_pc, pos_pc)):
                        cuts = cuts_pc[ci]
                        o, o_ep = offs[ci], offs_ep[ci]
                        w = self.widths[ci] if self.inline[ci] else 1
                        ps_all = (
                            ell.tables[ci][pcls].reshape(-1)
                            if self.inline[ci]
                            else pcls
                        )
                        for kk, (r0, r1) in enumerate(self.chunks):
                            lo, hi = cuts[kk], cuts[kk + 1]
                            # chunk-local row ids
                            er_all[kk, o : o + hi - lo] = rcls[lo:hi] - r0
                            ep_all[kk, o_ep : o_ep + (hi - lo) * w] = ps_all[
                                lo * w : hi * w
                            ]
                self.tables_flat = torch.from_numpy(tables_flat).to(self.device)
                self.er_all = torch.from_numpy(er_all).to(self.device)
                self.ep_all = torch.from_numpy(ep_all).to(self.device)
                # staged side operands (masks, fused-OR D), cached on identity
                self._mask_cache: dict = {}

    def _flat_kw(self):
        return dict(
            table_shapes=self.table_shapes, n_chunks=self.group_size,
            rows_pad=self.rows_pad, n_cols=self.n_cols,
            widths=self.widths, pads=self.pads, sort_pad=self.sort_pad,
        )

    def _row0s(self):
        for gi in range(self.n_groups):
            yield gi * self.group_size

    def _run_group(self, row0: int, kernel=None, *extra, **kw):
        """One dispatch group through ``kernel`` (the plain product's by
        default), ``kw`` overriding the plan's keywords."""
        if kernel is None:
            kernel = _flat_spgemm_sep2d if self.batched else _flat_spgemm_sep
            kw.setdefault("out_pad", self.out_pad)
        return kernel(self.tables_flat, self.er_all, self.ep_all, row0, *extra,
                      **{**self._flat_kw(), **kw})

    def _run_groups(self, kernel=None, *extra, **kw):
        """Every dispatch group, queued on the current stream without a host
        sync; the group outputs concatenate on the device."""
        outs = [self._run_group(row0, kernel, *extra, **kw)
                for row0 in self._row0s()]
        if len(outs) == 1:
            return outs[0]
        if isinstance(outs[0], torch.Tensor):  # one sum per chunk
            return torch.cat(outs)
        return tuple(torch.cat([o[i] for o in outs]) for i in range(len(outs[0])))

    def run(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Stacked per-chunk ``(c_indices [k_tot, out_pad], nnz [k_tot])``
        device tensors, row pointers embedded as ``n_cols`` separators.  One
        dispatch per chunk group.  Trailing dummy chunks (sentinel-only) may
        follow the real ones."""
        with span("call.run"):
            return self._run_groups()

    def run_padded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The one-sort device step: stacked ``(keys [k_tot, sort_pad], nnz
        [k_tot])``, each bin's sorted packed-key stream with ``INT32_MAX``
        holes (duplicates and sentinels demoted, not compacted), separators
        embedded.  :meth:`assemble_padded` compacts on the host.  It drops
        :meth:`run`'s second sort and pulls the whole stream instead of its
        valid prefixes.  Batched plans only."""
        if not self.batched:
            raise ValueError("run_padded requires a batched executor")
        with span("call.run_padded"):
            return self._run_groups(_flat_spgemm_padded2d)

    def assemble_padded(self, outputs) -> BCSR:
        """Host assembly of :meth:`run_padded`'s outputs: drop the holes,
        unpack the columns and hand each bin's separator-embedded stream to
        :meth:`assemble`'s batch assembler, so the CSR equals
        ``assemble(run())``."""
        dem_dev, nnz_dev = outputs
        valid = nnz_dev.cpu().numpy().astype(np.int64)
        valid[self.n_chunks :] = 0
        flat = dem_dev[: self.n_chunks].cpu().numpy().ravel()
        keys = flat[flat != INT32_MAX]
        cols = (keys & ((1 << int(self.n_cols).bit_length()) - 1)).astype(np.int32)
        chunk_idx = np.split(cols, np.cumsum(valid[: self.n_chunks])[:-1])
        return self._assemble_seps_batch(chunk_idx, valid)

    def staged_nnz_pad(self, mat: BCSR) -> int:
        """The per-chunk padded nnz that :meth:`stage_mask` gives a side
        operand; on a raw operand it bounds the canonical one's (dedup only
        shrinks rows), so callers budget ``run_or`` / ``run_masked`` before
        staging."""
        if self.row_sets is not None:
            per_bin = np.bincount(self._assign,
                                  weights=np.diff(mat.indptr).astype(np.float64),
                                  minlength=len(self.row_sets))
            return pad_bucket(max(int(per_bin.max()), 1))
        return pad_bucket(
            max(int(mat.indptr[r1] - mat.indptr[r0]) for r0, r1 in self.chunks)
        )

    def stage_mask(self, f: BCSR) -> tuple[torch.Tensor, torch.Tensor]:
        """Canonicalise, chunk-slice and stage a side operand (a mask or a
        fused-OR D) for :meth:`run_masked` / :meth:`run_or`: ``(ptr [k_tot,
        rows_pad + 1], idx [k_tot, f_pad])`` on the device, empty for the
        trailing dummy chunks.  Cached on the operand's identity, checked
        through a weakref (an id is reused once its object is freed)."""
        hit = self._mask_cache.get(id(f))
        if hit is not None:
            wf, staged = hit
            if wf() is f:
                return staged
            del self._mask_cache[id(f)]
        f_in = f
        if tuple(f.shape) != self.shape:
            raise ValueError(f"mask shape {f.shape} != product {self.shape}")
        with span("plan.stage", always=True):
            f = f.sum_duplicates()
            f_pad = self.staged_nnz_pad(f)
            if self.row_sets is not None:
                ptr_all, idx_all = _pad_rowset_csr_all(
                    f, self.row_sets, self.rows_pad, f_pad, fill=self.n_cols)
            else:
                parts = [pad_chunk_csr(f, r0, r1, self.rows_pad, f_pad, fill=self.n_cols)
                         for r0, r1 in self.chunks]
                ptr_all = np.stack([p[0] for p in parts])
                idx_all = np.stack([p[1] for p in parts])
            pad_n = self.n_groups * self.group_size - self.n_chunks
            if pad_n:  # trailing dummy group-fill chunks: empty
                ptr_all = np.concatenate(
                    [ptr_all, np.zeros((pad_n, self.rows_pad + 1), np.int32)])
                idx_all = np.concatenate(
                    [idx_all, np.full((pad_n, f_pad), self.n_cols, np.int32)])
            staged = (torch.from_numpy(ptr_all).to(self.device),
                      torch.from_numpy(idx_all).to(self.device))
        while len(self._mask_cache) >= 4:
            self._mask_cache.pop(next(iter(self._mask_cache)))
        self._mask_cache[id(f_in)] = (weakref.ref(f_in), staged)
        return staged

    def _staged(self, f):
        return f if isinstance(f, tuple) else self.stage_mask(f)

    def run_masked(self, f) -> tuple[torch.Tensor, torch.Tensor]:
        """C = F .* (A·B) with this executor's staged A and B (≡
        ``SpGEMM_masked``): stacked separator-embedded ``(c_indices, nnz)``,
        as :meth:`run`.  ``f`` is a :class:`BCSR` (staged here, cached) or
        :meth:`stage_mask`'s result."""
        kernel = _flat_masked2d if self.batched else _flat_masked
        with span("call.run_masked"):
            return self._run_groups(kernel, *self._staged(f))

    def run_or(self, d, mask=None):
        """C = D OR (A·B), or D OR (F .* (A·B)) with ``mask`` (≡ ``SpGEMM_dor``;
        D unconditional, see :mod:`.fused`), with this executor's staged A
        and B.  ``d`` and ``mask`` are :class:`BCSR` operands or
        :meth:`stage_mask` results.  Separator-embedded ``(c_indices, nnz)``
        as :meth:`run`, except the unrolled masked form, which returns
        chunk-local ``(c_indptr, c_indices, nnz)``."""
        with span("call.run_or"):
            d_ptr, d_idx = self._staged(d)
            if mask is None:
                # D's pairs lengthen every chunk's sort and bound its output
                sort_pad = pad_bucket(self.sort_pad + d_idx.shape[-1], div=32)
                out_pad = min(pad_bucket(self.out_pad + d_idx.shape[-1]), sort_pad)
                kernel = _flat_spgemm_sep2d if self.batched else _flat_spgemm_sep
                return self._run_groups(kernel, d_ptr, d_idx, sort_pad=sort_pad,
                                        out_pad=out_pad)
            if self.batched:  # the join keeps run()'s separator-embedded stream
                return self._run_groups(_flat_or_masked2d, d_ptr, d_idx,
                                        *self._staged(mask))
            return self._run_groups(_flat_or_masked, d_ptr, d_idx, *self._staged(mask),
                                    sort_pad=self.sort_pad - self.rows_pad)

    def run_counts(self):
        """C = A·B with each entry's multiplicity: on a batched plan stacked
        separator-embedded ``(c_indices, c_counts, nnz)``, on an unrolled one
        chunk-local ``(c_indptr, c_indices, c_counts, nnz)``.
        :meth:`assemble_counts` builds the host result.  The operands must
        be canonical (duplicate entries would inflate the counts)."""
        kernel = _flat_counts2d if self.batched else _flat_counts
        with span("call.run_counts"):
            return self._run_groups(kernel, out_pad=self.out_pad)

    def run_masked_counts(self, f):
        """C = F .* (A·B) with each entry's multiplicity (with ``f = a = b``
        an adjacency, the per-edge common-neighbour counts), in
        :meth:`run_counts`' forms.  ``f`` is a :class:`BCSR` or
        :meth:`stage_mask`'s result; a ``masked=True`` plan keeps the join
        key packed."""
        kernel = _flat_masked_counts2d if self.batched else _flat_masked_counts
        with span("call.run_masked_counts"):
            return self._run_groups(kernel, *self._staged(f))

    def run_counts_sum(self, f) -> torch.Tensor:
        """The sum over the entries (i, j) of F of the multiplicity of
        (A·B)[i, j], one int32 per chunk ``[k_tot]`` (the trailing dummy
        group-fill chunks give 0).  With ``f`` = A = B a symmetric hollow
        adjacency, the sum is 6 times the triangle count."""
        kernel = _flat_counts_sum2d if self.batched else _flat_counts_sum
        with span("call.run_counts_sum"):
            return self._run_groups(kernel, *self._staged(f))

    def assemble_counts(self, outputs) -> tuple[BCSR, np.ndarray]:
        """Pull the outputs of :meth:`run_counts` or
        :meth:`run_masked_counts` and build ``(BCSR, counts)``, ``counts[k]``
        (int64) the multiplicity of ``indices[k]``."""
        if len(outputs) == 3:  # batched: separator-embedded
            idx_dev, cnt_dev, nnz_dev = outputs
            ptr_dev = None
        else:
            ptr_dev, idx_dev, cnt_dev, nnz_dev = outputs
        nnz_c = nnz_dev.cpu().numpy()
        valid = nnz_c.astype(np.int64)
        valid[self.n_chunks :] = 0  # trailing dummy group-fill chunks
        chunk_idx = pull_chunk_prefixes(idx_dev, valid)
        chunk_cnt = pull_chunk_prefixes(cnt_dev, valid)
        if ptr_dev is None:
            return self._assemble_seps_batch(chunk_idx, valid, chunk_cnt)
        c_ptr = ptr_dev.cpu().numpy()
        return self._assemble_parts(
            [(c_ptr[i], chunk_idx[i], chunk_cnt[i], nnz_c[i])
             for i in range(self.n_chunks)])

    def assemble(self, outputs) -> BCSR:
        """Pull the outputs of :meth:`run`, :meth:`run_masked` or
        :meth:`run_or` and build the host CSR."""
        if len(outputs) == 3:  # chunk-local (indptr, indices, nnz)
            ptr_dev, idx_dev, nnz_dev = outputs
            c_ptr, nnz_c = ptr_dev.cpu().numpy(), nnz_dev.cpu().numpy()
            valid = nnz_c.astype(np.int64)
            valid[self.n_chunks :] = 0
            chunk_idx = pull_chunk_prefixes(idx_dev, valid)
            return self._assemble_parts(
                [(c_ptr[i], chunk_idx[i], nnz_c[i]) for i in range(self.n_chunks)])
        idx_dev, nnz_dev = outputs
        nnz_c = nnz_dev.cpu().numpy()
        valid = nnz_c.astype(np.int64)
        valid[self.n_chunks :] = 0  # trailing dummy group-fill chunks
        chunk_idx = pull_chunk_prefixes(idx_dev, valid)
        if self.n_chunks >= 256:
            # per-chunk python splitting costs seconds at thousands of
            # chunks: one vectorised pass instead
            return self._assemble_seps_batch(chunk_idx, valid)
        parts = [
            split_seps(chunk_idx[i], int(nnz_c[i]), self.rows_pad, self.n_cols)
            for i in range(self.n_chunks)
        ]
        return self._assemble_parts(parts)

    def _assemble_seps_batch(self, chunk_idx, valid: np.ndarray, chunk_cnt=None):
        """Vectorised host assembly of separator-embedded chunk streams: ONE
        pass over the concatenation instead of per-chunk ``split_seps``.
        With ``chunk_cnt`` (the counting family's counts, aligned with the
        index streams) it returns ``(BCSR, counts int64)``, the separators'
        count slots dropped with them."""
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
        # per-chunk exclusive row pointers off the separator positions
        bpos_k = bpos.reshape(k, self.rows_pad) - starts[:, None]
        ptr_tail = bpos_k - np.arange(self.rows_pad, dtype=np.int64)[None, :]
        lens_kl = np.diff(
            np.concatenate([np.zeros((k, 1), np.int64), ptr_tail], axis=1),
            axis=1,
        )  # [k, rows_pad] per-(chunk, local-row) entry counts
        indices_all = big[~sep_mask]  # (chunk, ascending local row) order
        if self.row_sets is not None:
            rows_concat = np.concatenate(self.row_sets)
            binsz = np.array([len(r) for r in self.row_sets], np.int64)
        else:
            rows_concat = np.concatenate(
                [np.arange(r0, r1, dtype=np.int64) for r0, r1 in self.chunks]
            )
            binsz = np.array([r1 - r0 for r0, r1 in self.chunks], np.int64)
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
        out = BCSR(indptr, indices, self.shape)
        if chunk_cnt is None:
            return out
        bigc = (np.concatenate([chunk_cnt[i] for i in range(k)]) if k
                else np.zeros(0, np.int32))
        counts = np.empty(total, np.int64)
        counts[dst] = bigc[~sep_mask]
        return out, counts

    def _assemble_parts(self, parts):
        if self.row_sets is not None:
            return _stitch_sets(self.row_sets, self.shape[0], self.shape, parts)
        it = iter(parts)
        return _stitch(
            self.chunks, self.shape[0], self.shape, lambda r0, r1: next(it)
        )

    def run_assemble_streaming(self) -> BCSR:
        """Compute and assemble with a host pull after every dispatch group:
        device memory holds one group's outputs at a time instead of the
        whole product's."""
        host_parts = []
        with span("call.run_assemble_streaming"):
            for row0 in self._row0s():
                idx_dev, nnz_dev = self._run_group(row0)
                with span("sync.pull"):
                    nnz = nnz_dev.cpu().numpy()
                    group_idx = pull_chunk_prefixes(idx_dev, nnz.astype(np.int64))
                for j in range(nnz.shape[0]):
                    host_parts.append(
                        split_seps(
                            group_idx[j], int(nnz[j]), self.rows_pad, self.n_cols
                        )
                    )
            return self._assemble_parts(host_parts[: self.n_chunks])


def _stitch_sets(row_sets, n_rows: int, shape, parts):
    """Host assembly for the dealt plan: scatter each bin's row segments back
    to their global rows.  ``parts`` is one ``(c_ptr, c_idx, nnz_c)`` triple
    per bin, or for the counting family ``(c_ptr, c_idx, c_cnt, nnz_c)``,
    whose counts scatter to the same places and come back as a second
    (int64) array; bin-local row ids were assigned in ascending global-row
    order, so each bin's compacted stream is already segment-ordered."""
    has_counts = bool(parts) and len(parts[0]) == 4
    lengths = np.zeros(n_rows, np.int64)
    for rows, part in zip(row_sets, parts):
        if len(rows):
            cp = np.asarray(part[0][: len(rows) + 1], dtype=np.int64)
            lengths[rows] = np.diff(cp)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    total = int(indptr[-1])
    indices = np.empty(total, np.int32)
    counts = np.empty(total, np.int64) if has_counts else None
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
        if has_counts:
            counts[dst] = np.asarray(part[2][:nnz_c])
    out = BCSR(indptr, indices, shape)
    return (out, counts) if has_counts else out


def _pad_rowset_csr_all(
    mat: BCSR, row_sets, rows_pad: int, nnz_pad: int, fill: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """``pad_chunk_csr`` for every dealt bin at once: each bin's rows of
    ``mat`` in the bin's order as a local CSR, stacked as ``(ptr [k, rows_pad
    + 1], idx [k, nnz_pad])``, padding rows empty and padding indices
    ``fill`` (a handful of numpy passes over the concatenated row sets)."""
    k = len(row_sets)
    rows_concat = (np.concatenate(row_sets) if k else np.zeros(0, np.int64)
                   ).astype(np.int64)
    binsz = np.array([len(r) for r in row_sets], np.int64)
    lens = (mat.indptr[rows_concat + 1] - mat.indptr[rows_concat]).astype(np.int64)
    cum = np.cumsum(lens)
    cum0 = np.concatenate([[0], cum])
    starts_chunk = np.cumsum(binsz) - binsz  # each bin's first row slot
    chunk_of = np.repeat(np.arange(k, dtype=np.int64), binsz)
    base = cum0[starts_chunk]  # entries before each bin
    totals = cum0[starts_chunk + binsz] - base
    local_end = cum - np.repeat(base, binsz)  # inclusive cumsum within a bin
    ptr = np.empty((k, rows_pad + 1), np.int32)
    ptr[:] = totals[:, None].astype(np.int32)
    ptr[:, 0] = 0
    within = np.arange(len(rows_concat), dtype=np.int64) - np.repeat(starts_chunk, binsz)
    ptr[chunk_of, within + 1] = local_end.astype(np.int32)
    idx = np.full((k, nnz_pad), fill, np.int32)
    nz = lens > 0
    if nz.any():
        src = _segment_sources(mat.indptr, rows_concat[nz], lens[nz])
        lr = lens[nz]
        dst = np.repeat(chunk_of[nz] * nnz_pad + local_end[nz] - lr, lr) + (
            np.arange(int(lr.sum()), dtype=np.int64) - np.repeat(np.cumsum(lr) - lr, lr)
        )
        idx.reshape(-1)[dst] = mat.indices[src]
    return ptr, idx


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
    masked: bool = False,
    allow_bsr: bool = False,
    device: str | torch.device = "cuda",
):
    """A staged executor for C = A·B, cached on operand IDENTITY (checked
    through weakrefs), ``masked``, ``allow_bsr`` and device; FIFO eviction at
    ``_EXEC_CACHE_MAX`` executors, oversized operands never cached.

    ``allow_bsr=True`` lets block-clustered plain products route to the
    staged blocked engine (:func:`..bsr.maybe_bsr_executor`); only callers
    that need nothing beyond ``assemble(run())`` may pass it, as the one-shot
    ``spgemm`` does (the blocked executor serves no op family).  Otherwise,
    and where the screen declines, the sliced-ELL plan of :func:`_auto_ell`
    (``masked`` for the op family's plan) serves the product."""
    device = torch.device(device)
    key = (id(a), id(b), masked, allow_bsr, str(device))
    hit = _EXEC_CACHE.get(key)
    if hit is not None:
        wa, wb, ex = hit
        if wa() is a and wb() is b:
            return ex
        del _EXEC_CACHE[key]
    ex = None
    with span("plan", always=True):
        if allow_bsr and not masked:
            from .bsr import maybe_bsr_executor

            with span("plan.search", always=True):
                ex = maybe_bsr_executor(a, b, device=device)
        if ex is None:
            ex = _auto_ell(a, b, masked=masked, device=device)
    if a.nnz + b.nnz <= _EXEC_CACHE_MAX_NNZ:
        while len(_EXEC_CACHE) >= _EXEC_CACHE_MAX:
            _EXEC_CACHE.pop(next(iter(_EXEC_CACHE)))
        _EXEC_CACHE[key] = (weakref.ref(a), weakref.ref(b), ex)
    return ex


def prefer_batched(a: BCSR, b: BCSR) -> bool:
    """Should the plain product use the batched 2-D engine on this input?
    Many rows (>= 2^16, or more than 160 packed chunks' worth) take it;
    fewer take the unrolled plan."""
    shift = int(b.n_cols).bit_length()
    cap = 1 << max(0, 30 - shift)
    return a.n_rows > 160 * cap or a.n_rows >= (1 << 16)


def _auto_ell(a: BCSR, b: BCSR, *, masked: bool = False,
              device: str | torch.device = "cuda"):
    """The ELL executor the auto path wants: batched 2-D when the many-rows
    rule says so AND the planned stream passes the skew guard, else the
    unrolled (contiguous or dealt) plan.  Raises ``OverflowError`` only when
    the unrolled plan overflows too."""
    if prefer_batched(a, b):
        try:
            return EllSpGEMMExecutor(
                a, b, masked=masked, batched=True,
                batched_slots_cap=BATCHED_MAX_SLOTS, device=device,
            )
        except OverflowError:
            pass
    return EllSpGEMMExecutor(a, b, masked=masked, device=device)


def tuned_executor(
    a: BCSR,
    b: BCSR,
    *,
    masked: bool = False,
    top: int = 6,
    margin: float = 1.15,
    times: int = 2,
    device: str | torch.device = "cuda",
) -> EllSpGEMMExecutor:
    """Pick the batched plan's bin count by measuring the model's best-ranked
    candidates on ``device`` and keeping the fastest.

    Candidates are every k whose model cost is within ``margin`` of the best
    (at most ``top``), plus the unrolled plan as ``k = 0``; each is built,
    run once to warm up, timed ``times`` times (CUDA events around
    ``run()`` on a card, the host clock on the CPU; the fastest kept) and
    released before the next is built, so at most two are resident.  The winner carries ``tune_report``,
    a sorted list of ``(seconds, k)``.  Candidates whose plan overflows or
    trips the skew guard are skipped, as are those the card has no memory
    for; any other failure raises.  If no batched plan exists, or no
    candidate survives, the unrolled plan is returned.  ``masked=True``
    tunes the op family's plans (each candidate built with ``masked=True``
    and timed on :meth:`~EllSpGEMMExecutor.run`, as in the JAX package)."""
    device = resolve_device(device)

    try:
        ex0 = EllSpGEMMExecutor(
            a, b, masked=masked, batched=True,
            batched_slots_cap=BATCHED_MAX_SLOTS, device=device,
        )
    except OverflowError:
        ex0 = None
    if ex0 is None or not ex0.batched:
        return EllSpGEMMExecutor(a, b, masked=masked, device=device)
    # every k within ``margin`` of the model's best, at most ``top`` of them:
    # the model ranks coarsely where tuning matters, so a cost margin keeps
    # every plausibly best plan
    ranking = sorted(ex0.k_ranking)
    cutoff = ranking[0][0] * max(margin, 1.0)
    ks = []
    for cost, k in ranking[: max(top, 1)]:
        if cost <= cutoff and k not in ks:
            ks.append(k)

    def measure(ex) -> float:
        # one warm-up run, then the fastest of ``times``: between CUDA events
        # on a card, on the host clock on the CPU
        if device.type == "cuda":
            with torch.cuda.device(device):
                return event_seconds(ex.run, repeats=max(times, 1)).fastest
        ex.run()
        return bench_fn(ex.run, repeats=max(times, 1)).fastest

    report, best, best_t = [], None, float("inf")
    if ex0.n_chunks not in ks:
        ex0 = None  # the seed plan is no candidate: release it up front
    for k in ks + [0]:
        try:
            if k == 0:
                ex = EllSpGEMMExecutor(a, b, masked=masked, device=device)
            elif ex0 is not None and k == ex0.n_chunks:
                ex = ex0
            else:
                ex = EllSpGEMMExecutor(
                    a, b, masked=masked, batched=True, deal_k=k,
                    batched_slots_cap=BATCHED_MAX_SLOTS, device=device,
                )
        except OverflowError:  # the plan overflows or trips the skew guard
            continue
        try:
            t = measure(ex)
        except torch.cuda.OutOfMemoryError:
            if ex is ex0:
                ex0 = None
            del ex
            torch.cuda.empty_cache()
            continue
        report.append((t, k))
        if t < best_t:
            best, best_t = ex, t
        if ex is ex0:
            ex0 = None  # measured: the seed need not stay resident on a loss
        del ex
    if best is None:
        return EllSpGEMMExecutor(a, b, masked=masked, device=device)
    best.tune_report = sorted(report)
    return best


def auto_executor(
    a: BCSR,
    b: BCSR,
    *,
    chunk_flops: int | None = None,
    device: str | torch.device = "cuda",
):
    """The executor for C = A·B on this input: block-clustered operands take
    the staged blocked engine (:func:`..bsr.maybe_bsr_executor`, a
    ``BsrStagedExecutor``); otherwise the sliced-ELL plan of
    :func:`_auto_ell` when its resident output fits ``AUTO_ELL_MAX_SLOTS``.
    Past that, or where every ELL plan overflows int32, the chunked ESC
    executor (:class:`..spgemm.SpGEMMExecutor`, with ``chunk_flops``)."""
    from .bsr import maybe_bsr_executor
    from .spgemm import SpGEMMExecutor

    with span("plan", always=True):
        with span("plan.search", always=True):
            bex = maybe_bsr_executor(a, b, device=device)
        if bex is not None:
            return bex
        try:
            ex = _auto_ell(a, b, device=device)
            if ex.resident_slots <= AUTO_ELL_MAX_SLOTS:
                return ex
            del ex  # release its staging before ESC stages
        except OverflowError:
            pass
        return SpGEMMExecutor(a, b, chunk_flops=chunk_flops, device=device)


def _chunk_bounds(rf: np.ndarray, budget: int, max_rows: int) -> list[int]:
    """Contiguous flop-balanced row boundaries with a hard per-chunk row cap."""
    chunks = _chunk_rows(rf, budget, max_rows)
    return [c[0] for c in chunks] + [chunks[-1][1]]


def ell_spgemm(
    a: BCSR, b: BCSR, *, device: str | torch.device = "cuda"
) -> BCSR:
    """One-shot C = A·B through the unrolled sliced-ELL plan."""
    ex = EllSpGEMMExecutor(a, b, device=device)
    return ex.assemble(ex.run())
