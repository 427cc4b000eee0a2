"""The expand–sort–compress (ESC) engine, its building blocks, and the one-shot
:func:`spgemm` with its routing.

Counterpart of ``binary_spgemm_tpu/ops/spgemm.py``.  ESC computes the
structure of C = A·B in three vectorised steps:

1. **Expand** every A-nonzero (i, j) into the candidate pairs
   ``{(i, k) : k in B(j,:)}`` (:func:`expand_pairs`): per-entry B-row lengths,
   a prefix sum, per-slot index streams built by scatter-add + cumsum and
   scatter-max + running maximum, and one gather from B's indices.  Slots are
   Gustavson flops, padded to ``flops_pad`` with ``(n_rows, n_cols)``
   sentinels.
2. **Sort** the pairs (:func:`sort_compress`): one int32 key
   ``(row << shift) | col`` when :func:`packable` holds, else one int64 key
   ``(row << 32) | col``, whose order is the (row, col) order.  These are
   1-D ``torch.sort`` calls; ESC launches no hand-written kernel.
3. **Compress**: drop left-neighbour duplicates and sentinels, demote them
   and sort again, so the valid entries form a prefix; row pointers come from
   a histogram or a searchsorted (:func:`_indptr`: a 1-D stream by
   :func:`_histogram_indptr_wins`, a stack by :func:`_search_indptr_wins`),
   or ride in the stream as embedded separators (:func:`sort_compress_seps`).

Around it: the device-resident container :class:`DeviceBCSR` (the
operands and results of ``ops/device_api.py``), the flop-balanced chunk
plan (:func:`uniform_chunk_plan`), the staged :class:`SpGEMMExecutor`, the
pipelined one-shot ESC route, the column-windowed route for giant rows
(:func:`_spgemm_giant`), the pulls of each chunk's valid prefix, and the
2-D separator step the sliced-ELL engines
sort with (:func:`sort_compress_seps_2d`, through :func:`..bitonic.sort_rows`:
K1 up to its longest row, ``torch.sort`` past it).  :func:`spgemm` routes as
the JAX package's does: the host engine for small products, the staged ELL
or blocked executor while its resident output fits, ESC past that, for an
explicit ``chunk_flops`` and where every ELL plan overflows, and the giant
route for rows past :data:`GIANT_ROW_FLOPS`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import native
from ..formats.bcsr import BCSR
from ..utils.trace import count, span
from .bitonic import sort_rows as sort_rows_1key

__all__ = [
    "COMPACT_PULL_BYTES",
    "DEFAULT_CHUNK_FLOPS",
    "DeviceBCSR",
    "GIANT_ROW_FLOPS",
    "SpGEMMExecutor",
    "blocked_route",
    "compact_chunks",
    "compact_pull",
    "esc_spgemm",
    "esc_spgemm_seps",
    "expand_pairs",
    "pad_bucket",
    "pad_chunk_csr",
    "packable",
    "pull_chunk_prefixes",
    "pull_padded_tuple",
    "pull_prefix",
    "require_int32_operands",
    "resolve_device",
    "row_flops",
    "sort_compress",
    "sort_compress_2d",
    "sort_compress_2d_keys",
    "sort_compress_masked",
    "sort_compress_masked_seps",
    "sort_compress_masked_seps_2d",
    "sort_compress_masked_seps_2d_keys",
    "sort_compress_seps",
    "sort_compress_seps_2d",
    "sort_compress_seps_2d_keys",
    "sort_compress_seps_keys",
    "spgemm",
    "spgemm_flops",
    "split_seps",
    "uniform_chunk_plan",
]

INT = torch.int32
INT32_MAX = (1 << 31) - 1

# Default per-chunk flop budget of the chunked ESC engine (verbatim).
DEFAULT_CHUNK_FLOPS = 1 << 25


def pad_bucket(n: int, minimum: int = 8, div: int = 16) -> int:
    """Round up to the next 1/``div``-octave bucket (multiples of 2^k/``div``
    within each power-of-two octave): <= ~100/div % waste, few distinct
    shapes per octave."""
    n = max(int(n), minimum)
    p = 1 << (n - 1).bit_length()  # smallest power of two >= n
    step = max(p // div, 1)
    return ((n + step - 1) // step) * step


def packable(n_rows: int, n_cols: int) -> bool:
    """Can (row, col) pairs pack into one positive int32 key?  Requires
    ``(n_rows + 1) * next_pow2(n_cols + 1) <= 2^31`` (sentinel row included)."""
    shift = int(n_cols).bit_length()  # n_cols < 2**shift: the col field holds n_cols
    return (n_rows + 1) << shift <= (1 << 31)


# ---------------------------------------------------------------------------
# Device-resident padded container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceBCSR:
    """Boolean CSR on a device with a padded index array.

    ``indptr`` is exact (int32 ``[n_rows+1]``); ``indices`` (int32) is padded
    to a bucket size with the tail undefined; ``nnz`` is a 0-d int32 tensor
    counting the valid entries, so ops that produce one need no host sync."""

    indptr: torch.Tensor
    indices: torch.Tensor
    nnz: torch.Tensor
    shape: tuple[int, int]

    @classmethod
    def from_host(
        cls,
        mat: BCSR,
        *,
        pad_to: int | None = None,
        require_canonical: bool = False,
        device: str | torch.device = "cuda",
    ) -> "DeviceBCSR":
        """Stage a host BCSR on ``device``.

        Pass ``require_canonical=True`` when the matrix feeds the counting
        family or is used as a mask: duplicate operand entries silently
        inflate multiplicities there (the boolean ops dedup in their sort)."""
        if require_canonical and not mat.is_canonical():
            raise ValueError(
                "operand is not canonical (per-row sorted, deduplicated); "
                "call .sum_duplicates() before staging — duplicate entries "
                "inflate counting-family multiplicities silently"
            )
        require_int32_operands(mat)
        device = resolve_device(device)
        pad = pad_to if pad_to is not None else pad_bucket(mat.nnz)
        idx = np.zeros(pad, dtype=np.int32)
        idx[: mat.nnz] = mat.indices
        return cls(
            indptr=torch.from_numpy(mat.indptr.astype(np.int32)).to(device),
            indices=torch.from_numpy(idx).to(device),
            nnz=torch.tensor(mat.nnz, dtype=INT, device=device),
            shape=tuple(mat.shape),
        )

    def to_host(self) -> BCSR:
        """Pull the valid prefix into a host BCSR."""
        ptr, idx, _ = pull_padded_tuple(self.indptr, self.indices, self.nnz)
        return BCSR(ptr, idx, self.shape)

    def compact(self, pad_to: int | None = None) -> "DeviceBCSR":
        """Repack into a tighter padded index array, staying on the device.

        Op outputs hold their valid entries in a prefix, so this is one slice
        (the only host sync reads ``nnz``; the pad is bucketed).  The
        iterated-product loops call it between rounds, so each round's
        expansion works on ``O(nnz)`` padding instead of the previous round's
        flop bound."""
        nnz = int(self.nnz)
        pad = pad_to if pad_to is not None else pad_bucket(max(nnz, 1))
        if pad < nnz:
            raise ValueError(f"pad_to {pad} would truncate {nnz} valid entries")
        if pad >= self.indices.shape[0]:
            return self
        return DeviceBCSR(self.indptr, self.indices[:pad], self.nnz, self.shape)


# ---------------------------------------------------------------------------
# Expansion
# ---------------------------------------------------------------------------


def _scatter_drop(size: int, fill: int, index: torch.Tensor, src: torch.Tensor,
                  reduce: str) -> torch.Tensor:
    """``jnp.full(size, fill).at[index].add(src)`` (``reduce="sum"``) or
    ``.max(src)`` (``"amax"``) along the last axis, with JAX's
    ``mode="drop"``: indices outside ``[0, size)`` are dropped.  They scatter
    into one extra slot that is cut off, since torch's scatters raise on
    them."""
    index = torch.where((index >= 0) & (index < size), index, size).long()
    buf = torch.full((*index.shape[:-1], size + 1), fill, dtype=src.dtype,
                     device=src.device)
    if reduce == "sum":
        buf.scatter_add_(-1, index, src)
    else:
        buf.scatter_reduce_(-1, index, src, "amax", include_self=True)
    return buf[..., :size]


# torch.cummax scans each row of its input in one thread block, so a 1-D
# tensor is one serial scan: about 2.7 ns a slot on an H100, nine tenths of
# ESC's device time (chip_smoke.py phase 16).  _running_max scans rows of
# this length in parallel instead.
_SCAN_ROW = 1024


def _running_max(x: torch.Tensor) -> torch.Tensor:
    """``torch.cummax(x, -1).values`` of an integer tensor: the running
    maximum within each segment of ``_SCAN_ROW`` slots of the last axis,
    then the maximum of all earlier segments carried in (itself a running
    maximum, over the segments' last slots)."""
    n = x.shape[-1]
    if n <= _SCAN_ROW:
        return torch.cummax(x, -1).values if n else x.clone()
    lead = x.shape[:-1]
    low = torch.iinfo(x.dtype).min
    pad = -n % _SCAN_ROW
    if pad:
        x = torch.cat([x, x.new_full((*lead, pad), low)], dim=-1)
    local = torch.cummax(x.reshape(*lead, -1, _SCAN_ROW), -1).values
    carry = _running_max(local[..., -1].contiguous())
    carry = torch.cat([carry.new_full((*lead, 1), low), carry[..., :-1]], dim=-1)
    return torch.maximum(local, carry[..., None]).reshape(*lead, -1)[..., :n]


def _owner_scan(starts: torch.Tensor, lengths: torch.Tensor, size: int) -> torch.Tensor:
    """For ``size`` flat slots partitioned into segments (``starts[k]`` the
    first slot of segment k, ``lengths[k]`` its extent), the owning segment
    id of each slot: a scatter-max of segment ids at their starts, then a
    running maximum.  Leading axes are a stack of independent scans."""
    k = torch.arange(starts.shape[-1], dtype=INT, device=starts.device).expand(starts.shape)
    dst = torch.where(lengths > 0, starts, size)  # empty segments own no slots
    return _running_max(_scatter_drop(size, 0, dst, k, "amax"))


def _row_ids(indptr: torch.Tensor, nnz_pad: int) -> torch.Tensor:
    """Row id of each CSR entry (the padded tail gets the last row id;
    callers mask); a stack of row-pointer arrays gives a stack of row ids."""
    return _owner_scan(indptr[..., :-1], indptr[..., 1:] - indptr[..., :-1], nnz_pad)


def _forward_fill_last(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``out[k] = values[j]`` for the largest ``j <= k`` with ``mask[j]`` (0
    where there is none): a running maximum of the masked positions, then a
    gather."""
    n = values.shape[0]
    tag = torch.where(mask, torch.arange(n, dtype=INT, device=values.device), -1)
    if n == 0:
        return values.clone()
    last = _running_max(tag)
    filled = torch.index_select(values, 0, last.clamp(min=0))
    return torch.where(last >= 0, filled, 0)


def expand_pairs(
    a_indptr: torch.Tensor,
    a_indices: torch.Tensor,
    a_nnz,
    b_indptr: torch.Tensor | None,
    b_indices: torch.Tensor,
    *,
    n_cols: int,
    flops_pad: int,
    b_row_starts: torch.Tensor | None = None,
    b_row_lens: torch.Tensor | None = None,
    b_col_base=0,
    check_total: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ESC expansion: all candidate (row, col) pairs of C = A·B, padded to
    ``flops_pad`` with ``(n_rows, n_cols)`` sentinels.  ``a_indices`` is
    padded; entries at or past ``a_nnz`` (an int or a 0-d tensor) expand to
    nothing.

    The B-index stream ``bidx[t]`` (which element of B's index array slot t
    reads) advances by one within a segment and jumps at segment starts, so
    it is the cumsum of ones with the jumps scatter-added at the (distinct)
    start slots; the output row id is nondecreasing over the slots, so it is
    the running maximum of row ids scatter-maxed at the starts.  The one
    per-slot gather is the data fetch ``b_indices[bidx]``.

    ``b_row_starts``/``b_row_lens`` replace B's CSR addressing: row j of B
    occupies ``b_indices[b_row_starts[j] : b_row_starts[j] + b_row_lens[j]]``
    (``b_indptr`` is ignored then).  ``b_col_base`` shifts that addressing to
    a window of B's rows ``[b_col_base, b_col_base + len(b_row_lens))``;
    A-entries whose column falls outside it expand to nothing.

    The JAX package keeps only the first ``flops_pad`` candidates and drops
    the rest without a signal.  Here a ``flops_pad`` below the product's
    candidate count raises ``ValueError`` (one host sync to read the count);
    callers whose ``flops_pad`` comes from the host plan (:func:`row_flops`)
    pass ``check_total=False`` and need no sync."""
    nnz_pad = a_indices.shape[0]
    n_rows = a_indptr.shape[0] - 1
    E = flops_pad
    dev = a_indices.device
    ar = torch.arange(nnz_pad, dtype=INT, device=dev)
    valid_a = ar < a_nnz
    acol = torch.where(valid_a, a_indices, 0)
    if b_row_starts is not None:
        local = acol - b_col_base
        n_local = b_row_lens.shape[0]
        in_window = (local >= 0) & (local < n_local)
        lidx = local.clamp(0, max(n_local - 1, 0))
        bstart = torch.index_select(b_row_starts, 0, lidx)
        blen = torch.where(valid_a & in_window, torch.index_select(b_row_lens, 0, lidx), 0)
    else:
        bstart = torch.index_select(b_indptr, 0, acol)
        blen = torch.where(valid_a, torch.index_select(b_indptr, 0, acol + 1) - bstart, 0)
    bstart, blen = bstart.to(INT), blen.to(INT)
    cum = torch.cumsum(blen, 0, dtype=INT)
    total = cum[-1] if nnz_pad else torch.zeros((), dtype=INT, device=dev)
    if check_total and int(total) > E:
        raise ValueError(
            f"flops_pad {E} is below the product's {int(total)} candidate "
            "pairs: the expansion would drop candidates"
        )
    offs = cum - blen
    rowid_a = _row_ids(a_indptr.to(INT), nnz_pad)

    # Jump corrections: delta[k] = bstart[k] - offs[k]; at the start slot of a
    # nonempty segment k, bidx jumps by delta[k] - delta[previous nonempty].
    ne = blen > 0
    delta = bstart - offs
    ff = _forward_fill_last(delta, ne)
    prev_delta = torch.cat([torch.zeros(1, dtype=INT, device=dev), ff[:-1]])[:nnz_pad]
    jumps = delta - prev_delta
    starts = torch.where(ne, offs, E)  # distinct for nonempty segments
    v = _scatter_drop(E, 1, starts, jumps, "sum")
    bidx = torch.cumsum(v, 0, dtype=INT) - 1

    row = _running_max(_scatter_drop(E, 0, starts, rowid_a, "amax"))

    valid_t = torch.arange(E, dtype=INT, device=dev) < total
    if b_indices.shape[0]:
        bidx = bidx.clamp(0, b_indices.shape[0] - 1)
        col = torch.index_select(b_indices.to(INT), 0, bidx)
    else:
        col = torch.full((E,), n_cols, dtype=INT, device=dev)
    row = torch.where(valid_t, row, n_rows)
    col = torch.where(valid_t, col, n_cols)
    return row, col


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


def _prev(x: torch.Tensor, fill: int) -> torch.Tensor:
    """Each slot's left neighbour along the last axis, ``fill`` at slot 0."""
    return torch.cat([x.new_full((*x.shape[:-1], 1), fill), x[..., :-1]], dim=-1)


def _sort(x: torch.Tensor, **kw):
    """``torch.sort(x, **kw)``, its slots added to the ``sort.slots`` count
    while tracing is on."""
    count("sort.slots", x.numel())
    return torch.sort(x, **kw)


def _compact_sorted(key: torch.Tensor, limit: int, demote: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort ``key``, keep the first of each run of equal keys below
    ``limit``, demote the rest to ``demote`` and sort again, so the kept keys
    form the prefix.  Returns ``(compacted keys, kept count)``."""
    with span("sort"):
        key_s = _sort(key).values
    with span("compress"):
        keep = (key_s != _prev(key_s, -1)) & (key_s < limit)
        nnz_c = keep.sum(dtype=INT)
        return _sort(torch.where(keep, key_s, demote)).values, nnz_c


def _pair_key(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """The int64 key ``(row << 32) | col`` of non-negative pairs: its order
    is the lexicographic (row, col) order of the JAX package's two-key
    ``lax.sort``."""
    return (row.to(torch.int64) << 32) | col.to(torch.int64)


def _histogram_indptr_wins(n_rows: int, n_slots: int) -> bool:
    """Pick the cheaper row-pointer formulation (verbatim from the JAX
    package, whose constants are TPU v5e per-chunk timings): searchsorted
    costs ~10 ns per each of its n_rows·log2(n_slots) random reads, the
    scatter-add histogram ~7 ns per each of its n_slots scattered writes.
    Both give the same ``indptr``."""
    log_len = max(math.log2(max(n_slots, 2)), 1.0)
    return n_rows * log_len * 10 > n_slots * 7


def _search_indptr_wins(n_rows: int, n_slots: int) -> bool:
    """Pick the row-pointer formulation of a stack of sorted streams from its
    shape alone: the searchsorted reads ``(n_rows + 1) * ceil(log2(n_slots))``
    positions of a row, the histogram scatters all ``n_slots``; the search
    wins where it reads no more.  The histogram's cost grows past that count
    where many slots share an address (the demoted tail of a compacted row
    is one bucket), which no shape tells, so the search is never the worse
    choice where this holds."""
    return (n_rows + 1) * (n_slots - 1).bit_length() <= n_slots


def _indptr_from_sorted_rows(rows_sorted: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Exclusive row pointers from per-entry row ids along the last axis: one
    scatter-add histogram and a cumsum.  Entries with ``row >= n_rows`` (sort
    sentinels, demoted slots) land in a tail bucket that is cut off; every
    such slot of a row adds to that one address.  :func:`_indptr` takes it
    for a 1-D stream where :func:`_histogram_indptr_wins` holds and for a
    stack where :func:`_search_indptr_wins` does not."""
    idx = torch.clamp(rows_sorted, max=n_rows).long() + 1
    counts = torch.zeros((*idx.shape[:-1], n_rows + 2), dtype=INT,
                         device=rows_sorted.device)
    counts.scatter_add_(-1, idx, torch.ones_like(idx, dtype=INT))
    return torch.cumsum(counts, -1, dtype=INT)[..., : n_rows + 1]


def _indptr_search(rows_sorted: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Exclusive row pointers of row ids sorted along the last axis, by one
    batched searchsorted: ``indptr[..., b]`` is the number of slots whose row
    is below ``b``.  Ids at or past ``n_rows`` sort last and count in no
    bound, so the pointers equal :func:`_indptr_from_sorted_rows`'."""
    bounds = torch.arange(n_rows + 1, dtype=rows_sorted.dtype,
                          device=rows_sorted.device)
    bounds = bounds.expand(*rows_sorted.shape[:-1], n_rows + 1).contiguous()
    return torch.searchsorted(rows_sorted, bounds, out_int32=True)


def _indptr(rows_sorted: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Exclusive row pointers of row ids sorted along the last axis
    (``[..., L]`` int32 or int64 -> ``[..., n_rows + 1]`` int32): a 1-D
    stream takes the formulation :func:`_histogram_indptr_wins` picks, a
    stack the searchsorted where :func:`_search_indptr_wins` holds for its
    row length, else the histogram.  Both give the same pointers; the
    ``indptr.search`` / ``indptr.histogram`` count says which ran."""
    n_slots = rows_sorted.shape[-1]
    if rows_sorted.dim() == 1:
        search = not _histogram_indptr_wins(n_rows, n_slots)
    else:
        search = _search_indptr_wins(n_rows, n_slots)
    if search:
        count("indptr.search")
        return _indptr_search(rows_sorted, n_rows)
    count("indptr.histogram")
    return _indptr_from_sorted_rows(rows_sorted, n_rows)


def sort_compress(
    row: torch.Tensor, col: torch.Tensor, n_rows: int, n_cols: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort candidate (row, col) pairs, deduplicate, and compact into CSR
    form.  Pairs with ``row == n_rows`` are padding sentinels.  Returns
    ``(c_indptr [n_rows+1], c_indices padded [len(row)], nnz_c)``."""
    if packable(n_rows, n_cols):
        shift = int(n_cols).bit_length()
        c_keys, nnz_c = _compact_sorted((row << shift) | col, n_rows << shift,
                                        INT32_MAX)
        return _indptr(c_keys >> shift, n_rows), c_keys & ((1 << shift) - 1), nnz_c
    c_keys, nnz_c = _compact_sorted(_pair_key(row, col), n_rows << 32,
                                    (n_rows << 32) | n_cols)
    return _indptr(c_keys >> 32, n_rows), (c_keys & 0xFFFFFFFF).to(INT), nnz_c


def sort_compress_seps_keys(
    key: torch.Tensor, n_rows: int, n_cols: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed branch of :func:`sort_compress_seps` on the pre-packed key
    stream (separator keys ``(r << shift) | n_cols`` included)."""
    shift = int(n_cols).bit_length()
    c_keys, nnz_c = _compact_sorted(key, n_rows << shift, INT32_MAX)
    return c_keys & ((1 << shift) - 1), nnz_c


def sort_compress_seps(
    row: torch.Tensor, col: torch.Tensor, n_rows: int, n_cols: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort, deduplicate and compact with **embedded row separators**: the
    caller appends one ``(r, n_cols)`` pair per output row, which sorts after
    row r's columns, is never a duplicate and survives compaction, so the
    host finds the row pointers at the separators (:func:`split_seps`).
    Returns ``(indices, nnz)``, ``nnz`` counting the separators too."""
    if packable(n_rows, n_cols):
        shift = int(n_cols).bit_length()
        return sort_compress_seps_keys((row << shift) | col, n_rows, n_cols)
    c_keys, nnz_c = _compact_sorted(_pair_key(row, col), n_rows << 32,
                                    (n_rows << 32) | n_cols)
    return (c_keys & 0xFFFFFFFF).to(INT), nnz_c


def _compress_2d_keys(key: torch.Tensor, n_rows: int, n_cols: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each row of the packed ``[k, L]`` key stream, drop left-neighbour
    duplicates and keys at or past the sentinel row, compact by demoting them
    to ``INT32_MAX`` and sorting again (both sorts through
    :func:`..bitonic.sort_rows`).  Returns the compacted keys and the per-row
    valid count ``nnz [k]`` (int32)."""
    shift = int(n_cols).bit_length()
    with span("sort"):
        key_s = sort_rows_1key(key)
    with span("compress"):
        keep = (key_s != _prev(key_s, -1)) & (key_s < (n_rows << shift))
        nnz_c = keep.sum(dim=1, dtype=INT)
        return sort_rows_1key(torch.where(keep, key_s, INT32_MAX)), nnz_c


def sort_compress_seps_2d_keys(
    key: torch.Tensor, n_rows: int, n_cols: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_compress_2d_keys` returning the column field of the compacted
    keys (separators embedded, so each chunk's row pointers ride in the
    stream) and the per-row valid count ``nnz [k]`` (int32)."""
    c_keys, nnz_c = _compress_2d_keys(key, n_rows, n_cols)
    return c_keys & ((1 << int(n_cols).bit_length()) - 1), nnz_c


def sort_compress_2d_keys(
    key: torch.Tensor, n_rows: int, n_cols: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched :func:`sort_compress` on the pre-packed ``[C, L]`` key stream
    ``(row << bl) | col``: each row of the stack sorts, deduplicates and
    compacts on its own (:func:`_compress_2d_keys`), and each row's exclusive
    row pointers come from its compacted row field (:func:`_indptr`).  Returns
    ``(c_indptr [C, n_rows+1], c_indices [C, L], nnz [C])``; the distributed
    ELL step serves all of a rank's sub-chunks with it."""
    shift = int(n_cols).bit_length()
    c_keys, nnz_c = _compress_2d_keys(key, n_rows, n_cols)
    # INT32_MAX (the demoted slots) shifts to past n_rows: counted in no row
    indptr = _indptr(c_keys >> shift, n_rows)
    return indptr, c_keys & ((1 << shift) - 1), nnz_c


def sort_compress_2d(
    row: torch.Tensor, col: torch.Tensor, n_rows: int, n_cols: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched :func:`sort_compress` on ``[C, L]`` (row, col) pair streams,
    sorted along the last axis.  Packable pairs take the packed int32 path
    (:func:`sort_compress_2d_keys`, K1); otherwise the pair sorts as one
    int64 key ``(row << 32) | col`` through ``torch.sort``, as the JAX
    package's 2-key ``lax.sort`` was plain XLA.  Returns ``(c_indptr [C,
    n_rows+1], c_indices [C, L], nnz [C])``."""
    if packable(n_rows, n_cols):
        shift = int(n_cols).bit_length()
        return sort_compress_2d_keys((row << shift) | col, n_rows, n_cols)
    with span("sort"):
        key_s = _sort(_pair_key(row, col), dim=1).values
    with span("compress"):
        keep = (key_s != _prev(key_s, -1)) & ((key_s >> 32) < n_rows)
        nnz_c = keep.sum(dim=1, dtype=INT)
        c_keys = _sort(torch.where(keep, key_s, (n_rows << 32) | n_cols),
                       dim=1).values
        indptr = _indptr((c_keys >> 32).to(INT), n_rows)
        return indptr, (c_keys & 0xFFFFFFFF).to(INT), nnz_c


def sort_compress_seps_2d(
    row: torch.Tensor, col: torch.Tensor, n_rows: int, n_cols: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sort_compress_seps_2d_keys` on ``[k, L]`` (row, col) pair
    streams.  Packable pairs take the packed int32 path; otherwise the pair
    sorts as one int64 key ``(row << 32) | col`` (both fields non-negative,
    so the int64 order is the (row, col) order) — plain ``torch.sort``, as
    the JAX package's 2-key ``lax.sort`` was plain XLA."""
    if packable(n_rows, n_cols):
        shift = int(n_cols).bit_length()
        return sort_compress_seps_2d_keys((row << shift) | col, n_rows, n_cols)
    with span("sort"):
        key_s = _sort(_pair_key(row, col), dim=1).values
    with span("compress"):
        keep = (key_s != _prev(key_s, -1)) & ((key_s >> 32) < n_rows)
        nnz_c = keep.sum(dim=1, dtype=INT)
        demoted = torch.where(keep, key_s, (n_rows << 32) | n_cols)
        c_keys = _sort(demoted, dim=1).values
        return (c_keys & 0xFFFFFFFF).to(INT), nnz_c


# ---------------------------------------------------------------------------
# Tagged joins: the masked and fused-OR compress steps
# ---------------------------------------------------------------------------


def _shr_logical(x: torch.Tensor, s: int) -> torch.Tensor:
    """``jax.lax.shift_right_logical`` of int32 ``x`` by ``1 <= s < 32``:
    torch's ``>>`` is arithmetic, so the copies of the sign bit it shifts
    in are masked off."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _sort_keys(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort along the last axis: a stack of int32 rows through
    :func:`..bitonic.sort_rows` (K1 within its window, ``torch.sort`` past
    it), as the ELL engines sort; a 1-D stream or int64 keys through
    ``torch.sort``, as ESC sorts."""
    if x.dim() == 2 and x.dtype == INT:
        return sort_rows_1key(x)
    return _sort(x, dim=-1).values


def _sort_tagged(blocks, n_rows: int, n_cols: int, tag_bits: int, payload=None):
    """The JAX package's three-key ``lax.sort((rows, cols, tags))`` along the
    last axis over the concatenated ``(row, col, tag)`` blocks (``tag`` an
    int per block): one int64 key ``(row << (c + t)) | (col << t) | tag``
    where it fits 63 bits, else two stable sorts, the low fields first.
    Returns the sorted rows, columns and tags (int32), and with ``payload``
    (a tensor laid out as the concatenated blocks) the payload in the
    sorted order too: the JAX package's ``lax.sort((rows, cols, tags,
    payload), num_keys=3)``."""
    cb = int(n_cols).bit_length() + tag_bits
    rows = torch.cat([r for r, _, _ in blocks], dim=-1).to(torch.int64)
    low = torch.cat([(c.to(torch.int64) << tag_bits) | t for _, c, t in blocks],
                    dim=-1)
    if int(n_rows).bit_length() + cb <= 63:
        key, perm = _sort((rows << cb) | low, dim=-1)
        rows, low = key >> cb, key & ((1 << cb) - 1)
    else:
        low, perm = _sort(low, dim=-1, stable=True)
        rows, perm2 = _sort(torch.gather(rows, -1, perm), dim=-1, stable=True)
        low, perm = torch.gather(low, -1, perm2), torch.gather(perm, -1, perm2)
    tag_mask = (1 << tag_bits) - 1
    out = rows.to(INT), (low >> tag_bits).to(INT), (low & tag_mask).to(INT)
    return out if payload is None else (*out, torch.gather(payload, -1, perm))


def _compact_pairs(keep, row_s, col_s, n_rows: int, n_cols: int):
    """Demote the pairs ``keep`` drops to ``(n_rows, n_cols)`` and sort again
    (one int64 key), so the kept pairs form the prefix.  Returns ``(columns,
    row ids, nnz)`` of the compacted stream."""
    nnz_c = keep.sum(-1, dtype=INT)
    c_keys = _sort(torch.where(keep, _pair_key(row_s, col_s),
                               (n_rows << 32) | n_cols), dim=-1).values
    return (c_keys & 0xFFFFFFFF).to(INT), c_keys >> 32, nnz_c


def _masked_compress(row, col, f_row, f_col, n_rows: int, n_cols: int, *,
                     seps: bool, key=None):
    """The sort-fused mask join along the last axis: mask pairs join the
    candidate stream tagged to sort first within an equal (row, col) run, so
    a candidate survives iff its left neighbour is its own pair's mask
    entry (later duplicates see a candidate and die).  With ``seps`` the
    ``(r, n_cols)`` candidates (row separators) survive unconditionally.
    ``f_row``/``f_col`` are sentinel-masked already.

    Where ``packable(n_rows, 2 * n_cols + 1)`` the join key is the int32
    ``(plain key << 1) | 1`` (``key`` the plain packed keys ``(row << bl) |
    col``, else built from the pairs) and the mask's ``(row << bl + 1) |
    (col << 1)``; otherwise the three-key sort of :func:`_sort_tagged`.
    Returns ``(columns, row ids, nnz)`` of the compacted stream."""
    if packable(n_rows, 2 * n_cols + 1):
        bl = int(n_cols).bit_length()
        shift, col_mask = bl + 1, (1 << bl) - 1
        if key is None:
            key = (row << bl) | col
        key_s = _sort_keys(torch.cat([(key << 1) | 1,
                                      (f_row << shift) | (f_col << 1)], dim=-1))
        is_cand = (key_s & 1) == 1
        in_range = key_s < ((n_rows << shift) | 1)
        keep = is_cand & (_prev(key_s, -2) == (key_s & ~1)) & in_range
        if seps:
            keep |= is_cand & in_range & (((key_s >> 1) & col_mask) == n_cols)
        nnz_c = keep.sum(-1, dtype=INT)
        c_keys = _sort_keys(torch.where(keep, key_s, INT32_MAX))
        return (c_keys >> 1) & col_mask, c_keys >> shift, nnz_c
    row_s, col_s, tag_s = _sort_tagged([(row, col, 1), (f_row, f_col, 0)],
                                       n_rows, n_cols, 1)
    in_range = row_s < n_rows
    keep = ((tag_s == 1) & (row_s == _prev(row_s, -1))
            & (col_s == _prev(col_s, -1)) & (_prev(tag_s, 1) == 0) & in_range)
    if seps:
        keep |= (tag_s == 1) & (col_s == n_cols) & in_range
    return _compact_pairs(keep, row_s, col_s, n_rows, n_cols)


def _mask_tail(f_row, f_col, f_nnz, n_rows: int, n_cols: int):
    """Padded mask pairs with the slots at or past ``f_nnz`` set to the
    ``(n_rows, n_cols)`` sentinel."""
    valid = torch.arange(f_row.shape[-1], dtype=INT, device=f_row.device) < f_nnz
    return torch.where(valid, f_row, n_rows), torch.where(valid, f_col, n_cols)


def sort_compress_masked(row, col, f_row, f_col, f_nnz, n_rows: int, n_cols: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked sort/compress: keep the candidate pairs that appear in mask F
    (:func:`_masked_compress`).  ``f_row``/``f_col`` are padded mask pairs
    (slots at or past ``f_nnz`` are ignored); F must be canonical.  Same
    sentinels and return contract as :func:`sort_compress`, over ``len(row)
    + len(f_row)`` slots."""
    f_row, f_col = _mask_tail(f_row, f_col, f_nnz, n_rows, n_cols)
    cols, rows, nnz_c = _masked_compress(row, col, f_row, f_col, n_rows, n_cols,
                                         seps=False)
    return _indptr(rows, n_rows), cols, nnz_c


def sort_compress_masked_seps(row, col, f_row, f_col, f_nnz, n_rows: int,
                              n_cols: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sort_compress_masked` with embedded row separators (callers
    append one ``(r, n_cols)`` candidate per output row; they survive the
    join unconditionally).  Returns ``(indices, nnz)``.  The unrolled ELL
    engine runs the 2-D form over a dispatch group, whose rows are this."""
    f_row, f_col = _mask_tail(f_row, f_col, f_nnz, n_rows, n_cols)
    return sort_compress_masked_seps_2d(row, col, f_row, f_col, n_rows, n_cols)


def sort_compress_masked_seps_2d(row, col, f_row, f_col, n_rows: int, n_cols: int
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched :func:`sort_compress_masked_seps`: ``[k, Lc]`` candidate
    streams (separators included) and ``[k, Pf]`` sentinel-masked mask
    pairs, joined along the last axis.  Returns separator-embedded
    ``(indices [k, Lc + Pf], nnz [k])``."""
    cols, _, nnz_c = _masked_compress(row, col, f_row, f_col, n_rows, n_cols,
                                      seps=True)
    return cols, nnz_c


def sort_compress_masked_seps_2d_keys(key, f_row, f_col, n_rows: int, n_cols: int
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sort_compress_masked_seps_2d` on the pre-packed plain key
    stream ``(row << bl) | col`` (the caller checks ``packable(n_rows, 2 *
    n_cols + 1)``); the join key is ``(key << 1) | 1``."""
    cols, _, nnz_c = _masked_compress(None, None, f_row, f_col, n_rows, n_cols,
                                      seps=True, key=key)
    return cols, nnz_c


def split_seps(
    indices: np.ndarray, nnz: int, n_rows: int, n_cols: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Host inverse of the separator embedding: split a compacted chunk
    stream into ``(indptr [n_rows+1], indices, real_nnz)``."""
    valid = indices[:nnz]
    bpos = np.flatnonzero(valid == n_cols)
    if len(bpos) != n_rows:
        raise RuntimeError(
            f"separator-count invariant violated: found {len(bpos)} row "
            f"separators in the compacted stream, expected {n_rows}"
        )
    ptr = np.empty(n_rows + 1, np.int64)
    ptr[0] = 0
    ptr[1:] = bpos - np.arange(n_rows, dtype=np.int64)
    return ptr, np.delete(valid, bpos), int(nnz) - n_rows


# ---------------------------------------------------------------------------
# ESC products
# ---------------------------------------------------------------------------


def esc_spgemm(
    a_indptr: torch.Tensor,
    a_indices: torch.Tensor,
    a_nnz,
    b_indptr: torch.Tensor,
    b_indices: torch.Tensor,
    *,
    n_cols: int,
    flops_pad: int,
    check_total: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ESC SpGEMM over padded CSR tensors.  Returns ``(c_indptr [n_rows+1],
    c_indices padded [flops_pad], nnz_c)``."""
    n_rows = a_indptr.shape[0] - 1
    row, col = expand_pairs(
        a_indptr, a_indices, a_nnz, b_indptr, b_indices,
        n_cols=n_cols, flops_pad=flops_pad, check_total=check_total,
    )
    return sort_compress(row, col, n_rows, n_cols)


def esc_spgemm_seps(
    a_indptr: torch.Tensor,
    a_indices: torch.Tensor,
    a_nnz,
    b_indptr: torch.Tensor,
    b_indices: torch.Tensor,
    *,
    n_cols: int,
    flops_pad: int,
    check_total: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`esc_spgemm` with embedded row separators
    (:func:`sort_compress_seps`): the host splits the row pointers off the
    compacted stream (:func:`split_seps`).  Returns ``(c_indices padded
    [flops_pad + n_rows], nnz including the separators)``."""
    n_rows = a_indptr.shape[0] - 1
    with span("expand"):
        row, col = expand_pairs(
            a_indptr, a_indices, a_nnz, b_indptr, b_indices,
            n_cols=n_cols, flops_pad=flops_pad, check_total=check_total,
        )
        dev = row.device
        row = torch.cat([row, torch.arange(n_rows, dtype=INT, device=dev)])
        col = torch.cat([col, torch.full((n_rows,), n_cols, dtype=INT, device=dev)])
    return sort_compress_seps(row, col, n_rows, n_cols)


# ---------------------------------------------------------------------------
# Host-level planning
# ---------------------------------------------------------------------------


def row_flops(a: BCSR, b: BCSR) -> np.ndarray:
    """Per-output-row Gustavson flop counts of A·B (host: one parallel
    native pass, :func:`..native.row_weight`, within its size guard)."""
    blen = np.diff(b.indptr).astype(np.int64)
    if a.nnz:
        out = native.row_weight(a.indptr, a.indices, blen)
        if out is not None:
            return out
    return _row_flops_numpy(a, blen)


def _row_flops_numpy(a: BCSR, blen: np.ndarray) -> np.ndarray:
    """The numpy branch of :func:`row_flops` (``blen``: B's row lengths)."""
    per_entry = blen[a.indices] if a.nnz else np.zeros(0, np.int64)
    cum = np.zeros(a.nnz + 1, dtype=np.int64)
    np.cumsum(per_entry, out=cum[1:])
    return cum[a.indptr[1:]] - cum[a.indptr[:-1]]


def spgemm_flops(a: BCSR, b: BCSR) -> int:
    """Total Gustavson flop count (sum over A-nonzeros (i,j) of nnz(B row j))."""
    return int(row_flops(a, b).sum())


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device where there is no card
    raises instead of quietly switching to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the host")
    return device


def require_int32_operands(*mats: BCSR) -> None:
    """Operand entry positions feed int32 device gathers: an operand past the
    int32 entry domain raises instead of wrapping."""
    for mat in mats:
        if mat.nnz > np.iinfo(np.int32).max:
            raise OverflowError(
                f"operand nnz {mat.nnz} exceeds the int32 device index "
                "domain; matrices this large are supported as outputs but "
                "not as multiply operands"
            )


def _chunk_rows(
    rf: np.ndarray, chunk_flops: int, max_rows: int | None = None
) -> list[tuple[int, int]]:
    """Greedy contiguous row partition with <= ``chunk_flops`` per chunk (a
    single row past the budget gets its own chunk) and at most ``max_rows``
    rows per chunk."""
    n = len(rf)
    if n == 0:
        return [(0, 0)]
    cum = np.zeros(n + 1, np.int64)
    np.cumsum(rf, out=cum[1:])
    chunks = []
    start = 0
    while start < n:
        end = (
            int(np.searchsorted(cum, cum[start] + chunk_flops, side="right"))
            - 1
        )
        if cum[end] == cum[start] and end < n:
            # zero-flop prefix: the first flop-carrying row rides along even
            # when it alone exceeds the budget (a chunk is never all-padding)
            end += 1
        if max_rows is not None:
            end = min(end, start + max_rows)
        end = min(max(end, start + 1), n)
        chunks.append((start, end))
        start = end
    return chunks


def uniform_chunk_plan(
    a: BCSR,
    rf: np.ndarray,
    chunk_flops: int,
    n_cols: int | None = None,
    *,
    force_pack: bool = False,
) -> tuple[list[tuple[int, int]], int, int, int]:
    """Flop-bounded contiguous row chunks, all padded to the same
    ``(rows_pad, nnz_pad, flops_pad)`` (verbatim from the JAX package, where
    one shape is one compilation).

    With ``n_cols``, rows per chunk are also capped so (row, col) pairs pack
    into one int32 key (:func:`packable`), but only where the cap does not
    raise the chunk count, or always with ``force_pack``.  A row whose flop
    count passes int32 raises ``OverflowError``: a chunk is never smaller
    than one row, and its prefix sums are int32."""
    max_row_flops = int(rf.max()) if len(rf) else 0
    if max_row_flops > np.iinfo(np.int32).max:
        raise OverflowError(
            f"row flop count {max_row_flops} exceeds int32; "
            "int64 expansion is not implemented yet"
        )
    total = int(rf.sum())
    if total <= chunk_flops:
        base = [(0, a.n_rows)]
    else:
        base = _chunk_rows(rf, chunk_flops)
    chunks = base
    if n_cols is not None:
        shift = int(n_cols).bit_length()
        cap = 1 << max(0, 30 - shift)
        rows_max = max(r1 - r0 for r0, r1 in base)
        if rows_max > cap and cap >= 512:
            capped = _chunk_rows(rf, chunk_flops, cap)
            if force_pack or len(capped) <= len(base):
                chunks = capped
    rows_pad = pad_bucket(max(r1 - r0 for r0, r1 in chunks))
    nnz_pad = pad_bucket(
        max(int(a.indptr[r1] - a.indptr[r0]) for r0, r1 in chunks)
    )
    flops_pad = pad_bucket(max(int(rf[r0:r1].sum()) for r0, r1 in chunks))
    return chunks, rows_pad, nnz_pad, flops_pad


def pad_chunk_csr(
    mat: BCSR, r0: int, r1: int, rows_pad: int, nnz_pad: int, fill: int = 0
) -> tuple[np.ndarray, np.ndarray, int]:
    """Rows ``[r0, r1)`` of ``mat`` as uniformly padded local CSR arrays:
    padding rows are empty (the indptr tail repeats nnz), padding indices
    are ``fill``.  Returns ``(indptr [rows_pad+1], indices [nnz_pad],
    nnz_local)``."""
    nnz_local = int(mat.indptr[r1] - mat.indptr[r0])
    ptr = np.full(rows_pad + 1, nnz_local, np.int32)
    ptr[: r1 - r0 + 1] = mat.indptr[r0 : r1 + 1] - mat.indptr[r0]
    idx = np.full(nnz_pad, fill, np.int32)
    idx[:nnz_local] = mat.indices[mat.indptr[r0] : mat.indptr[r1]]
    return ptr, idx, nnz_local


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory without a host
    sync on a card, so a pipelined dispatch does not wait for the device."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# Pulls
# ---------------------------------------------------------------------------

# Compact-before-pull gate: below this padded size the straight padded pull
# is cheap and the device-side gather is not worth it.
COMPACT_PULL_BYTES = 64 << 20

# One compaction pass's flat-size cap: compact_chunks flattens to [C*P] and
# gathers with int32 positions.  Bigger stacks compact in chunk groups.
_COMPACT_FLAT_MAX = (1 << 31) - 1

# Single-block compaction's device-memory budget (the gather holds ~4
# stack-sized int32 temporaries); past it the stack compacts in chunk groups
# of about _COMPACT_GROUP_BYTES each.
_COMPACT_BLOCK_BYTES = 1 << 31
_COMPACT_GROUP_BYTES = 1 << 29


def compact_chunks(idx: torch.Tensor, nnz: torch.Tensor) -> torch.Tensor:
    """Pack per-chunk valid prefixes of a stacked ``[C, P]`` index array into
    one contiguous ``[C*P]`` stream (chunk-major; positions past the combined
    total repeat the clamped last source).  The source of output slot i is
    ``chunk(i)*P + i - offset[chunk(i)]``, with ``chunk(i)`` a searchsorted
    over the chunk-total prefix sums: one gather pass, no sort."""
    C, Pp = idx.shape
    nnz = nnz.to(INT)
    cum = torch.cumsum(nnz, 0, dtype=INT)
    off = cum - nnz
    i = torch.arange(C * Pp, dtype=INT, device=idx.device)
    chunk = torch.searchsorted(cum, i, right=True, out_int32=True).clamp_(
        max=C - 1
    )
    src = chunk * Pp + (i - off[chunk])
    src = src.clamp_(0, C * Pp - 1)
    return torch.index_select(idx.reshape(-1), 0, src)


def pull_prefix(flat: torch.Tensor, total: int) -> np.ndarray:
    """``flat[:total]`` on the host, in one copy."""
    return flat[: max(int(total), 0)].cpu().numpy()


def should_compact_pull(C: int, Pp: int, itemsize: int, total: int) -> bool:
    """Gate for compact-before-pull: the padded stack must be big enough to
    notice on the link and carry enough padding to pay for the device-side
    gather."""
    if C * Pp * itemsize <= COMPACT_PULL_BYTES:
        return False
    return total <= 0.85 * C * Pp


def _compact_pull_block(idx: torch.Tensor, nnz_valid: np.ndarray) -> list:
    """Compact one ``[C, P]`` block (flat size < 2^31) and pull its combined
    valid prefix; split back per chunk."""
    C, Pp = idx.shape
    total = int(nnz_valid.sum())
    if C == 1:  # a single chunk's valid data is already a dense prefix
        return [pull_prefix(idx.reshape(-1), total)]
    nnz = torch.from_numpy(np.asarray(nnz_valid, np.int32)).to(idx.device)
    host = pull_prefix(compact_chunks(idx, nnz), total)
    cuts = np.concatenate([[0], np.cumsum(nnz_valid.astype(np.int64))])
    return [host[cuts[i] : cuts[i + 1]] for i in range(C)]


def compact_pull(idx: torch.Tensor, nnz_valid: np.ndarray) -> list | None:
    """Compact a stacked padded ``[C, P]`` chunk-index device array and pull
    only the combined valid prefix, split back into per-chunk host arrays.
    Returns ``None`` when the straight padded pull is the better plan (small
    result or little padding).  Stacks past int32 flat addressing or the
    block budget compact in uniform groups of chunks."""
    C, Pp = idx.shape
    itemsize = idx.element_size()
    total = int(nnz_valid.sum())
    if not should_compact_pull(C, Pp, itemsize, total):
        return None
    if C * Pp <= _COMPACT_FLAT_MAX and C * Pp * itemsize <= _COMPACT_BLOCK_BYTES:
        return _compact_pull_block(idx, nnz_valid)
    G = max(
        1, min(_COMPACT_FLAT_MAX // Pp, _COMPACT_GROUP_BYTES // (Pp * itemsize))
    )
    parts: list = []
    for g0 in range(0, C, G):
        g1 = min(g0 + G, C)
        parts.extend(_compact_pull_block(idx[g0:g1], nnz_valid[g0:g1]))
    return parts


def pull_chunk_prefixes(idx_dev: torch.Tensor, nnz_valid: np.ndarray) -> list:
    """Each chunk's valid prefix of a stacked ``[C, P]`` device array on the
    host: compact-before-pull when profitable, else one padded pull sliced
    host-side."""
    parts = compact_pull(idx_dev, nnz_valid)
    if parts is not None:
        return parts
    host = idx_dev.cpu().numpy()
    return [host[i, : int(nnz_valid[i])] for i in range(host.shape[0])]


class _Prefetch:
    """A card tensor's copy into pinned host memory, queued on the current
    stream without a host sync; :meth:`numpy` waits for the copy's event.
    (A non-blocking copy into pageable memory, or a read before the event,
    would give wrong data rather than an error.)"""

    def __init__(self, x: torch.Tensor):
        self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        self.host.copy_(x, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def numpy(self) -> np.ndarray:
        self.event.synchronize()
        return self.host.numpy()


def _host(x) -> np.ndarray:
    """A prefetched copy or a tensor on the host as numpy."""
    return x.numpy() if isinstance(x, _Prefetch) else x.cpu().numpy()


def pull_padded_tuple(c_ptr, c_idx, nnz_c) -> tuple[np.ndarray, np.ndarray, int]:
    """One chunk's ``(indptr, indices, nnz)`` on the host (each a tensor or a
    :class:`_Prefetch`): the indices' valid prefix in one copy."""
    nnz_i = int(_host(nnz_c))
    if isinstance(c_idx, _Prefetch):
        idx = c_idx.numpy()[:nnz_i]
    else:
        idx = pull_prefix(c_idx, nnz_i)
    return _host(c_ptr), idx, nnz_i


# ---------------------------------------------------------------------------
# Stitching
# ---------------------------------------------------------------------------


def _stitch(chunks, rows_total, shape, run_chunk):
    """Run ``run_chunk(r0, r1) -> (c_ptr, c_idx, nnz_c)`` per contiguous row
    chunk and stitch the slices with a row-pointer prefix fix.  Chunk-local
    pointers are int32; the host bases are int64, so the stitched indptr
    widens once the total passes the int32 domain.  Parts of the counting
    family, ``(c_ptr, c_idx, c_cnt, nnz_c)``, stitch their counts alongside:
    the result is then ``(BCSR, counts int64)``."""
    indptr_parts = [np.zeros(1, np.int64)]
    index_parts, count_parts = [], []
    base = 0
    for r0, r1 in chunks:
        part = run_chunk(r0, r1)
        c_ptr, c_idx, nnz_c = part[0], part[1], int(part[-1])
        index_parts.append(np.asarray(c_idx[:nnz_c]))
        if len(part) == 4:
            count_parts.append(np.asarray(part[2][:nnz_c]))
        local = np.asarray(c_ptr[1 : r1 - r0 + 1], dtype=np.int64)
        indptr_parts.append(local + base)
        base += nnz_c
    indptr = np.concatenate(indptr_parts)
    indices = (
        np.concatenate(index_parts) if index_parts else np.zeros(0, np.int32)
    )
    out = BCSR(indptr, indices, shape)
    if not count_parts:
        return out
    return out, np.concatenate(count_parts).astype(np.int64)


def _stitch_pipelined(chunks, rows_total, shape, dispatch, finish):
    """:func:`_stitch` with a one-deep dispatch/finish pipeline:
    ``dispatch(r0, r1)`` queues one chunk's device work and returns its
    output tensors; ``finish(out)`` pulls and splits them (blocking).  Chunk
    i+1's work is queued before chunk i's pull, so the pull and the host
    split overlap the device.  Outputs of at most ``COMPACT_PULL_BYTES`` on
    a card start their copy to pinned host memory at dispatch; bigger ones
    wait for ``finish``'s gated prefix pull."""

    def prefetch(out):
        return tuple(
            _Prefetch(x)
            if x.is_cuda and x.numel() * x.element_size() <= COMPACT_PULL_BYTES
            else x
            for x in out
        )

    parts: list = []
    prev = None
    for r0, r1 in chunks:
        cur = prefetch(dispatch(r0, r1))
        if prev is not None:
            parts.append(finish(prev))
        prev = cur
    parts.append(finish(prev))
    it = iter(parts)
    return _stitch(chunks, rows_total, shape, lambda r0, r1: next(it))


# ---------------------------------------------------------------------------
# The chunked ESC executor
# ---------------------------------------------------------------------------


class SpGEMMExecutor:
    """Pre-staged repeated C = A·B through the chunked ESC engine.

    Plans the flop-balanced chunks (:func:`uniform_chunk_plan`) and stages
    once: A's chunks as the stacks ``a_ptr [C, rows_pad+1]``, ``a_idx [C,
    nnz_pad]`` and ``a_nnz [C]``, and B, on ``device``.  :meth:`run` queues
    every chunk's :func:`esc_spgemm_seps` on the current stream, each writing
    into its row of the preallocated outputs, and returns ``(idx [C, flops_pad
    + rows_pad], nnz [C])``; :meth:`assemble` pulls each chunk's valid prefix
    and splits its separators off."""

    def __init__(
        self,
        a: BCSR,
        b: BCSR,
        *,
        chunk_flops: int | None = None,
        device: str | torch.device = "cuda",
    ):
        if a.n_cols != b.n_rows:
            raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
        require_int32_operands(a, b)
        self.device = resolve_device(device)
        self.shape = (a.n_rows, b.n_cols)
        chunk_flops = chunk_flops or DEFAULT_CHUNK_FLOPS
        with span("plan", always=True):
            with span("plan.search", always=True):
                rf = row_flops(a, b)
                self.chunks, rows_pad, nnz_pad, self.flops_pad = uniform_chunk_plan(
                    a, rf, chunk_flops, b.n_cols
                )
            self.n_cols = b.n_cols
            self._rows_pad = rows_pad
            C = len(self.chunks)
            with span("plan.stage", always=True):
                ptrs = np.empty((C, rows_pad + 1), np.int32)
                idxs = np.empty((C, nnz_pad), np.int32)
                nnzs = np.empty(C, np.int32)
                for i, (r0, r1) in enumerate(self.chunks):
                    ptrs[i], idxs[i], nnzs[i] = pad_chunk_csr(
                        a, r0, r1, rows_pad, nnz_pad)
                dev = self.device
                self.b_indptr = torch.from_numpy(b.indptr.astype(np.int32)).to(dev)
                self.b_indices = torch.from_numpy(b.indices.astype(np.int32)).to(dev)
                self.a_ptr = torch.from_numpy(ptrs).to(dev)
                self.a_idx = torch.from_numpy(idxs).to(dev)
                self.a_nnz = torch.from_numpy(nnzs).to(dev)

    def run(self) -> tuple[torch.Tensor, torch.Tensor]:
        """One full multiply: the stacked ``(c_indices, nnz_c)`` device
        tensors, row pointers embedded as separators (:meth:`assemble`
        splits them off).  No host sync."""
        C = len(self.chunks)
        with span("call.run"):
            idx = torch.empty((C, self.flops_pad + self._rows_pad), dtype=INT,
                              device=self.device)
            nnz = torch.empty(C, dtype=INT, device=self.device)
            for i in range(C):
                idx[i], nnz[i] = esc_spgemm_seps(
                    self.a_ptr[i], self.a_idx[i], self.a_nnz[i], self.b_indptr,
                    self.b_indices, n_cols=self.n_cols, flops_pad=self.flops_pad,
                    check_total=False,
                )
            return idx, nnz

    def assemble(self, outputs) -> BCSR:
        """Pull :meth:`run`'s outputs and build the host CSR."""
        idx_dev, nnz_dev = outputs
        nnz_c = nnz_dev.cpu().numpy()
        chunk_idx = pull_chunk_prefixes(idx_dev, nnz_c.astype(np.int64))
        parts = iter(
            split_seps(chunk_idx[s], int(nnz_c[s]), self._rows_pad, self.n_cols)
            for s in range(len(self.chunks))
        )
        return _stitch(self.chunks, self.shape[0], self.shape,
                       lambda r0, r1: next(parts))


# ---------------------------------------------------------------------------
# One-shot routing
# ---------------------------------------------------------------------------


def blocked_route(
    a: BCSR, b: BCSR, *, device: str | torch.device = "cuda"
) -> BCSR | None:
    """Opt-in one-shot blocked route (:func:`..bsr.bsr_spgemm`) for
    block-clustered products.  Not taken by :func:`spgemm`, which reaches
    the blocked engine through the staged executor instead.  Returns
    ``None`` if the input isn't block-clustered enough (per-touched-tile
    fill < 5%), is too small to judge, or its block structure is too
    large."""
    from .bsr import block_clustering_ratio, bsr_spgemm

    # only meaningful at scale: tiny shapes make the per-tile ratio noise
    if a.nnz < (1 << 17) or min(*a.shape, *b.shape) < 2048:
        return None
    min_fill = 0.05 * 128 * 128  # >= 5% tile fill
    if block_clustering_ratio(a) < min_fill:
        return None
    if b is not a and block_clustering_ratio(b) < min_fill:
        return None
    from ..formats.bbcsr import BlockedBCSR

    blk_a = BlockedBCSR.from_bcsr(a, 128)
    blk_b = blk_a if b is a else BlockedBCSR.from_bcsr(b, 128)
    # bound pair count / output blocks so the dense tiles stay in memory
    pair_flops = spgemm_flops(blk_a.structure, blk_b.structure)
    if blk_a.n_blocks > 32768 or blk_b.n_blocks > 32768 or pair_flops > 65536:
        return None
    return bsr_spgemm(blk_a, blk_b, device=device).to_bcsr()


# A single output row whose Gustavson flop count exceeds this takes the
# column-windowed route (:func:`_spgemm_giant`), since the chunked engines'
# per-chunk prefix sums are int32.  Module-level so tests can lower it.
GIANT_ROW_FLOPS = 1 << 30


def _spgemm_giant(a: BCSR, b: BCSR, rf: np.ndarray, chunk_flops,
                  device: str | torch.device) -> BCSR:
    """C = A·B when some single rows pass :data:`GIANT_ROW_FLOPS`.  Each
    giant row's A-entries are split into flop-bounded windows, every window
    runs as a 1-row product through :func:`spgemm`, and the window results
    are unioned on the host (windows partition B's rows, so one output
    column can come from several).  The other rows take the standard route
    as one product with the giant rows emptied."""
    budget = GIANT_ROW_FLOPS
    giant = np.flatnonzero(rf > budget)
    # rest-matrix: giant rows emptied, everything else verbatim
    lens = np.diff(a.indptr).astype(np.int64)
    lens_rest = lens.copy()
    lens_rest[giant] = 0
    keep = np.ones(a.nnz, bool)
    for i in giant:
        keep[a.indptr[i] : a.indptr[i + 1]] = False
    indptr_rest = np.zeros(a.n_rows + 1, np.int64)
    np.cumsum(lens_rest, out=indptr_rest[1:])
    a_rest = BCSR(indptr_rest, a.indices[keep], a.shape)
    c_rest = spgemm(a_rest, b, chunk_flops=chunk_flops, device=device)

    blen = np.diff(b.indptr).astype(np.int64)
    giant_rows: dict[int, np.ndarray] = {}
    for i in giant:
        entries = a.indices[a.indptr[i] : a.indptr[i + 1]]
        csum = np.cumsum(blen[entries])
        parts = []
        lo = 0
        while lo < len(entries):
            # the largest window starting at lo with total flops <= budget
            hi = int(np.searchsorted(
                csum, (csum[lo - 1] if lo else 0) + budget, side="right"))
            if hi <= lo:
                # one entry alone passes the budget: its result is exactly
                # that B row's distinct columns
                j = entries[lo]
                parts.append(np.unique(b.indices[b.indptr[j] : b.indptr[j + 1]]))
                lo += 1
                continue
            sub = BCSR(np.array([0, hi - lo], np.int64), entries[lo:hi],
                       (1, b.n_rows))
            parts.append(spgemm(sub, b, chunk_flops=chunk_flops, device=device).indices)
            lo = hi
        giant_rows[int(i)] = (
            np.unique(np.concatenate(parts)) if len(parts) > 1 else parts[0]
        )

    # splice the giant rows into the rest-result, copying the runs between
    out_lens = np.diff(c_rest.indptr).astype(np.int64)
    for i, cols in giant_rows.items():
        out_lens[i] = len(cols)
    indptr = np.zeros(a.n_rows + 1, np.int64)
    np.cumsum(out_lens, out=indptr[1:])
    indices = np.empty(int(indptr[-1]), np.int32)
    src_pos = 0
    cursor = 0
    for i in sorted(giant_rows):
        run = int(c_rest.indptr[i]) - src_pos
        indices[cursor : cursor + run] = c_rest.indices[src_pos : src_pos + run]
        cursor += run
        src_pos = int(c_rest.indptr[i + 1])  # skip the (empty) giant row
        cols = giant_rows[i]
        indices[cursor : cursor + len(cols)] = cols
        cursor += len(cols)
    run = c_rest.nnz - src_pos
    indices[cursor : cursor + run] = c_rest.indices[src_pos:]
    return BCSR(indptr, indices, (a.n_rows, b.n_cols))


def _esc_one_shot(a: BCSR, b: BCSR, rf: np.ndarray, chunk_flops: int,
                  device: torch.device) -> BCSR:
    """The pipelined one-shot ESC driver: each chunk padded and uploaded at
    dispatch, its valid prefix pulled and split at finish."""
    m = b.n_cols
    chunks, rows_pad, nnz_pad, flops_pad = uniform_chunk_plan(a, rf, chunk_flops, m)
    b_indptr = _upload(b.indptr.astype(np.int32), device)
    b_indices = _upload(b.indices.astype(np.int32), device)

    def dispatch(r0, r1):
        ptr, idx, nnz_local = pad_chunk_csr(a, r0, r1, rows_pad, nnz_pad)
        return esc_spgemm_seps(
            _upload(ptr, device), _upload(idx, device), nnz_local,
            b_indptr, b_indices, n_cols=m, flops_pad=flops_pad,
            check_total=False,
        )

    def finish(out):
        c_idx, nnz_c = out
        nnz_i = int(_host(nnz_c))
        # a big chunk pulls only its valid prefix off the device
        if isinstance(c_idx, torch.Tensor) and should_compact_pull(
                1, c_idx.shape[0], c_idx.element_size(), nnz_i):
            host = pull_prefix(c_idx, nnz_i)
        else:
            host = _host(c_idx)
        return split_seps(host, nnz_i, rows_pad, m)

    return _stitch_pipelined(chunks, a.n_rows, (a.n_rows, m), dispatch, finish)


def spgemm(
    a: BCSR,
    b: BCSR,
    *,
    chunk_flops: int | None = None,
    device: str | torch.device = "cuda",
) -> BCSR:
    """Boolean SpGEMM structure C = A·B, one shot, on ``device``.

    Routes as the JAX package's ``spgemm`` does: a row past
    :data:`GIANT_ROW_FLOPS` flops sends the product to the column-windowed
    route; products of at most ``HOST_MAX_FLOPS`` flops take the host engine
    (:func:`..host.host_spgemm`, on the host whatever ``device`` says); the
    rest go through :func:`..ell.cached_executor` with ``allow_bsr=True``
    (the blocked route for block-clustered operands, else the sliced-ELL
    plans) while its resident output fits ``AUTO_ELL_MAX_SLOTS``.  An
    explicit ``chunk_flops``, a product past that budget, and one where
    every ELL plan overflows int32 take the chunked ESC engine."""
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
    require_int32_operands(a, b)
    n, m = a.n_rows, b.n_cols
    if a.nnz == 0 or b.nnz == 0:
        return BCSR(np.zeros(n + 1, np.int32), np.zeros(0, np.int32), (n, m))
    rf_total = row_flops(a, b)
    if len(rf_total) and int(rf_total.max()) > GIANT_ROW_FLOPS:
        return _spgemm_giant(a, b, rf_total, chunk_flops, device)
    if chunk_flops is None:
        # small-flop products cost less on the host than one device round trip
        from .host import HOST_MAX_FLOPS, host_spgemm

        if int(rf_total.sum()) <= HOST_MAX_FLOPS:
            return host_spgemm(a, b)
        from .ell import AUTO_ELL_MAX_SLOTS, cached_executor

        # block-clustered products take the staged blocked engine; repeated
        # calls on the same operands reuse the staged tiles through the cache
        try:
            ex = cached_executor(a, b, allow_bsr=True, device=device)
        except OverflowError:
            ex = None  # every ELL plan overflows int32: ESC below
        if ex is not None and (getattr(ex, "engine", None) == "bsr"
                               or ex.resident_slots <= AUTO_ELL_MAX_SLOTS):
            return ex.assemble(ex.run())
    return _esc_one_shot(a, b, rf_total, chunk_flops or DEFAULT_CHUNK_FLOPS,
                         resolve_device(device))
