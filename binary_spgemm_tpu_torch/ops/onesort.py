"""One-sort device-resident SpGEMM: padded streams with sentinel holes.

Counterpart of ``binary_spgemm_tpu/ops/onesort.py``.  Every ESC multiply
ends with a compaction sort whose only job is to squeeze the demoted
duplicates out of an already sorted stream (``sort_compress``: sort,
dedup-demote, sort again).  The iterated products here (reachability
closure, k-hop) skip it: each consumes the previous round's uncompacted
stream directly, so every round pays one sort instead of two.

Representation (:class:`PaddedDeviceBCSR`): the deduplicated sorted stream
without the compaction sort — per-row column runs in ascending order with
the demoted duplicates left in place as ``n_cols`` holes, plus a positional
row pointer (spans include the holes).  Expansion against such an operand
gathers row ``j``'s span whole, and hole slots expand to sentinels.  The
price is stream inflation: holes ride along as dead slots into the next
round.  :meth:`PaddedDeviceBCSR.compact` (one sort) bounds that when the
hole fraction compounds.

The sorts are 1-D ``torch.sort`` calls, as the JAX package's are XLA sorts:
an int32 ``(row << shift) | col`` key where it packs, else the int64 pair
key (:func:`..spgemm._pair_key`) or the tagged key
(:func:`..spgemm._sort_tagged`).  The sorted keys are unique apart from
identical sentinels, so the streams are element-equal to the JAX package's
whatever the sort's stability.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.bcsr import BCSR
from .spgemm import (
    INT,
    DeviceBCSR,
    _forward_fill_last,
    _indptr,
    _pair_key,
    _prev,
    _row_ids,
    _running_max,
    _scatter_drop,
    _shr_logical,
    _sort_tagged,
    packable,
    pad_bucket,
)

__all__ = [
    "PaddedDeviceBCSR",
    "flops_bound_onesort",
    "spgemm_onesort_device",
    "spgemm_or_onesort_device",
]

_LOW32 = 0xFFFFFFFF


@dataclasses.dataclass
class PaddedDeviceBCSR:
    """Device-resident one-sort CSR: a sorted column stream with holes.

    ``cols[indptr_pos[j] : indptr_pos[j+1]]`` holds row ``j``'s columns in
    ascending order, interleaved with ``n_cols`` holes (demoted duplicates);
    positions past ``indptr_pos[n_rows]`` are an all-sentinel tail.  ``nnz``
    is a 0-d int32 tensor counting the valid (``< n_cols``) entries."""

    cols: torch.Tensor  # int32 [E], holes and tail = n_cols
    indptr_pos: torch.Tensor  # int32 [n_rows + 1], positional (spans incl. holes)
    nnz: torch.Tensor  # int32 0-d, valid entries
    shape: tuple[int, int]

    @property
    def stream_len(self) -> int:
        return self.cols.shape[0]

    @classmethod
    def from_device(cls, mat: DeviceBCSR) -> "PaddedDeviceBCSR":
        """Wrap a compact :class:`..spgemm.DeviceBCSR` (no holes, no sort):
        its row pointers are positional already; the undefined padded tail
        becomes sentinels."""
        n_cols = mat.shape[1]
        e = mat.indices.shape[0]
        valid = torch.arange(e, dtype=INT, device=mat.indices.device) < mat.nnz
        cols = torch.where(valid, mat.indices, n_cols)
        return cls(cols, mat.indptr.to(INT), mat.nnz, tuple(mat.shape))

    @classmethod
    def from_host(cls, mat: BCSR, *, device: str | torch.device = "cuda"
                  ) -> "PaddedDeviceBCSR":
        return cls.from_device(DeviceBCSR.from_host(mat, device=device))

    def compact(self, pad_to: int | None = None) -> DeviceBCSR:
        """Squeeze the holes out with one sort: a :class:`..spgemm.DeviceBCSR`.
        This is the sort the one-sort rounds skip; call it at the pipeline's
        exit, or between rounds when the holes compound.  Reads ``nnz`` on
        the host to bucket the output pad."""
        n_rows, n_cols = self.shape
        rows = _row_ids(self.indptr_pos, self.stream_len)
        valid = self.cols < n_cols
        rows = torch.where(valid, rows, n_rows)
        key_s = torch.sort(_pair_key(rows, self.cols)).values
        indptr = _indptr(key_s >> 32, n_rows)
        dev = DeviceBCSR(indptr, (key_s & _LOW32).to(INT), self.nnz, tuple(self.shape))
        nnz = int(self.nnz)
        pad = pad_to if pad_to is not None else pad_bucket(max(nnz, 1))
        return dev.compact(pad_to=max(pad, nnz))

    def to_host(self) -> BCSR:
        """Pull the stream and compact it on the host (no device sort): drop
        the holes, derive row pointers from the positional spans."""
        n_rows, n_cols = self.shape
        cols = self.cols.cpu().numpy()
        pos = self.indptr_pos.cpu().numpy().astype(np.int64)
        valid = np.flatnonzero(cols < n_cols)
        counts = np.diff(np.searchsorted(valid, pos))
        indptr = np.zeros(n_rows + 1, np.int32)
        np.cumsum(counts, out=indptr[1:])
        return BCSR(indptr, cols[valid].astype(np.int32), tuple(self.shape))


def _expand_from_padded(
    a_cols: torch.Tensor,
    a_indptr_pos: torch.Tensor,
    b_cols: torch.Tensor,
    b_indptr_pos: torch.Tensor,
    *,
    n_cols: int,
    flops_pad: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ESC expansion where both operands are padded hole-y streams: the
    formulation of :func:`..spgemm.expand_pairs` (cumsum B-index stream,
    running-maximum row ids), with validity by ``col < n_cols`` and B's
    hole slots expanding to sentinels.  A's holes are its own column count,
    the inner dimension ``len(b_indptr_pos) - 1``.  (The JAX package tests
    A's entries against the product's ``n_cols`` instead, so where the inner
    dimension is larger it drops A's entries past ``n_cols`` and returns a
    short product.)

    The JAX package keeps the first ``flops_pad`` candidates and drops the
    rest without a signal.  Here a ``flops_pad`` below the padded span
    count raises ``ValueError`` (one host sync to read the count)."""
    e_a = a_cols.shape[0]
    n_rows = a_indptr_pos.shape[0] - 1
    E = flops_pad
    dev = a_cols.device
    valid_a = a_cols < b_indptr_pos.shape[0] - 1
    acol = torch.where(valid_a, a_cols, 0)
    bstart = torch.index_select(b_indptr_pos, 0, acol)
    blen = torch.where(valid_a, torch.index_select(b_indptr_pos, 0, acol + 1) - bstart, 0)
    cum = torch.cumsum(blen, 0, dtype=INT)
    total = cum[-1] if e_a else torch.zeros((), dtype=INT, device=dev)
    if int(total) > E:
        raise ValueError(
            f"flops_pad {E} is below the product's {int(total)} candidate "
            "slots: the expansion would drop candidates"
        )
    offs = cum - blen
    rowid_a = _row_ids(a_indptr_pos, e_a)

    ne = blen > 0
    delta = bstart - offs
    ff = _forward_fill_last(delta, ne)
    prev_delta = torch.cat([torch.zeros(1, dtype=INT, device=dev), ff[:-1]])[:e_a]
    jumps = delta - prev_delta
    starts = torch.where(ne, offs, E)
    bidx = torch.cumsum(_scatter_drop(E, 1, starts, jumps, "sum"), 0, dtype=INT) - 1
    row = _running_max(_scatter_drop(E, 0, starts, rowid_a, "amax"))

    t = torch.arange(E, dtype=INT, device=dev)
    if b_cols.shape[0]:
        col = torch.index_select(b_cols, 0, bidx.clamp(0, b_cols.shape[0] - 1))
    else:
        col = torch.full((E,), n_cols, dtype=INT, device=dev)
    # a hole slot inside B's span expands to a full sentinel (a live row id
    # with col n_cols must not survive the dedup bound)
    ok = (t < total) & (col < n_cols)
    return torch.where(ok, row, n_rows), torch.where(ok, col, n_cols)


def _sort_dedup_padded(row, col, n_rows: int, n_cols: int):
    """One sort and the dedup-demote, no compaction sort: returns ``(cols
    [len(row)], indptr_pos [n_rows+1], nnz)``, the
    :class:`PaddedDeviceBCSR` fields.  The valid set is
    :func:`..spgemm.sort_compress`'s: the same sort and keep rule.  The
    positional pointers count every position of the sorted stream, so
    duplicates become in-span holes."""
    if packable(n_rows, n_cols):
        shift = int(n_cols).bit_length()
        key_s = torch.sort((row << shift) | col).values
        keep = (key_s != _prev(key_s, -1)) & (key_s < (n_rows << shift))
        row_s = _shr_logical(key_s, shift)
        cols = torch.where(keep, key_s & ((1 << shift) - 1), n_cols)
    else:
        key_s = torch.sort(_pair_key(row, col)).values
        row_s = key_s >> 32
        keep = (key_s != _prev(key_s, -1)) & (row_s < n_rows)
        cols = torch.where(keep, (key_s & _LOW32).to(INT), n_cols)
    return cols, _indptr(row_s, n_rows), keep.sum(dtype=INT)


def _sort_dedup_padded_masked(row, col, d_rows, d_cols, f_rows, f_cols,
                              n_rows: int, n_cols: int):
    """The one-sort three-way tagged join D OR (F .* candidates),
    uncompacted: the join of :func:`..fused._sort_compress_or_masked` (mask
    < D < candidate within an equal (row, col) run; a D entry survives as
    its run's first D, a candidate only behind its pair's mask entry)
    without the compaction sort.  Losers become in-span holes, and so do
    the mask's own entries (they are never output)."""
    if packable(n_rows, 4 * n_cols + 3):
        shift = int(n_cols).bit_length() + 2
        key_s = torch.sort(torch.cat([
            ((row << shift) | (col << 2)) | 2,  # candidates last in a run
            ((d_rows << shift) | (d_cols << 2)) | 1,
            (f_rows << shift) | (f_cols << 2),  # the mask first
        ])).values
        prev = _prev(key_s, -1)
        same = _shr_logical(key_s, 2) == _shr_logical(prev, 2)
        tag, prev_tag = key_s & 3, prev & 3
        keep_d = (tag == 1) & (~same | (prev_tag == 0))
        keep_c = (tag == 2) & same & (prev_tag == 0)
        keep = (keep_d | keep_c) & (key_s < ((n_rows << shift) | 2))
        row_s = _shr_logical(key_s, shift)
        cols = torch.where(keep, (key_s >> 2) & ((1 << (shift - 2)) - 1), n_cols)
        return cols, _indptr(row_s, n_rows), keep.sum(dtype=INT)
    row_s, col_s, tag_s = _sort_tagged(
        [(row, col, 2), (d_rows, d_cols, 1), (f_rows, f_cols, 0)], n_rows, n_cols, 2)
    same = (row_s == _prev(row_s, -1)) & (col_s == _prev(col_s, -1))
    prev_tag = _prev(tag_s, 2)
    keep_d = (tag_s == 1) & (~same | (prev_tag == 0))
    keep_c = (tag_s == 2) & same & (prev_tag == 0)
    keep = (keep_d | keep_c) & (row_s < n_rows)
    return (torch.where(keep, col_s, n_cols), _indptr(row_s, n_rows),
            keep.sum(dtype=INT))


def _as_padded(x) -> PaddedDeviceBCSR:
    if isinstance(x, PaddedDeviceBCSR):
        return x
    if isinstance(x, DeviceBCSR):
        return PaddedDeviceBCSR.from_device(x)
    raise TypeError(f"expected a device container, got {type(x).__name__}")


def _stream_pairs(x: PaddedDeviceBCSR):
    """``(rows, cols)`` of a padded stream, holes and tail as sentinels."""
    n_rows, n_cols = x.shape
    rows = _row_ids(x.indptr_pos, x.stream_len)
    return torch.where(x.cols < n_cols, rows, n_rows), x.cols


def _onesort_core(d, a, b, *, shape, flops_pad: int, mask=None):
    n_rows, n_cols = shape
    row, col = _expand_from_padded(a.cols, a.indptr_pos, b.cols, b.indptr_pos,
                                   n_cols=n_cols, flops_pad=flops_pad)
    if d is None:
        return _sort_dedup_padded(row, col, n_rows, n_cols)
    d_rows, d_cols = _stream_pairs(d)
    if mask is None:
        # the SPA pre-seed analogue: D's stream joins the candidates as it
        # is; its holes are sentinels already, its entries dedup like any
        # candidate
        return _sort_dedup_padded(torch.cat([row, d_rows]), torch.cat([col, d_cols]),
                                  n_rows, n_cols)
    f_rows, f_cols = _stream_pairs(mask)
    return _sort_dedup_padded_masked(row, col, d_rows, d_cols, f_rows, f_cols,
                                     n_rows, n_cols)


def spgemm_onesort_device(a, b, *, flops_pad: int) -> PaddedDeviceBCSR:
    """C = A·B structure, one sort, on the device.  ``a``/``b`` may be
    :class:`..spgemm.DeviceBCSR` or :class:`PaddedDeviceBCSR` (padded
    operands are consumed as they are: their holes cost dead gather slots,
    no compaction).  ``flops_pad`` must bound the padded span flop count
    (:func:`flops_bound_onesort`); a smaller one raises ``ValueError``."""
    a, b = _as_padded(a), _as_padded(b)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
    shape = (a.shape[0], b.shape[1])
    cols, pos, nnz = _onesort_core(None, a, b, shape=shape, flops_pad=flops_pad)
    return PaddedDeviceBCSR(cols, pos, nnz, shape)


def spgemm_or_onesort_device(d, a, b, *, flops_pad: int, mask=None
                             ) -> PaddedDeviceBCSR:
    """C = D OR (A·B), or with ``mask`` D OR (mask .* (A·B)), one sort, on
    the device: the one-sort accumulation round.  D is unconditional, the
    mask applies to the product term only.  ``mask``'s valid set must be
    canonical; a hole-y stream qualifies.  The mask's entries ride the
    output stream as extra in-span holes, so masked rounds inflate the
    stream by the mask's length until the next compaction."""
    d, a, b = _as_padded(d), _as_padded(a), _as_padded(b)
    if a.shape[1] != b.shape[0] or tuple(d.shape) != (a.shape[0], b.shape[1]):
        raise ValueError(f"shape mismatch: D{d.shape} vs {a.shape} @ {b.shape}")
    shape = tuple(d.shape)
    f = None
    if mask is not None:
        f = _as_padded(mask)
        if tuple(f.shape) != shape:
            raise ValueError(f"mask shape {f.shape} != {shape}")
    cols, pos, nnz = _onesort_core(d, a, b, shape=shape, flops_pad=flops_pad, mask=f)
    return PaddedDeviceBCSR(cols, pos, nnz, shape)


def flops_bound_onesort(a, b) -> tuple[torch.Tensor, torch.Tensor]:
    """The padded-span flop bound of a·b: an exact int32 sum and a float32
    estimate that does not wrap, the overflow guard's reading.  Spans
    include b's holes: the stream length the one-sort round allocates.  A's
    valid entries are those below its own column count (the JAX package
    tests them against b's, which undercounts where a has more columns than
    b)."""
    a, b = _as_padded(a), _as_padded(b)
    valid = a.cols < a.shape[1]
    acol = torch.where(valid, a.cols, 0)
    span = torch.where(valid, torch.index_select(b.indptr_pos, 0, acol + 1)
                       - torch.index_select(b.indptr_pos, 0, acol), 0)
    return span.sum(dtype=INT), span.to(torch.float32).sum()
