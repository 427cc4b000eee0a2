"""Counting SpGEMM: the structure of C = A·B plus each entry's multiplicity.

Counterpart of ``binary_spgemm_tpu/ops/counts.py``.  For 0/1 operands the
multiplicity of output entry (i, j), the number of expansion candidates that
collapse into it, is the integer product's value |{k : A[i,k] and B[k,j]}|.
It falls out of the sort-based compression: an exclusive running count of
the valid candidates rides the compaction sort as a payload, and each
surviving (first) candidate's count is the payload difference to the next
survivor (:func:`_counts_stage`).

The first sort of each compress step is a plain key sort: a stack of int32
rows goes through :func:`..bitonic.sort_rows` (K1 within its window,
``torch.sort`` past it), a 1-D stream (ESC) or int64 keys through
``torch.sort``.  The payload sorts, ``lax.sort((keys, payload), num_keys=1)``
in the JAX package (XLA sorts, not Pallas kernels), are ``torch.sort`` of the
keys and a ``torch.gather`` of the payload.  Neither sort is stable; the
results do not depend on the order of equal keys because kept keys are
unique and every demoted slot's count is cut to 0.  Where a pair does not
pack into one int32 key, the JAX package's two- and three-key sorts become
one int64 key (``(row << 32) | col``, or ``..spgemm._sort_tagged``'s).

:func:`triangle_count_device` needs no output arrays: one tagged sort (mask
entries first within an equal (row, col) run) and two running maxima mark
every candidate whose run is masked (:func:`_masked_run_marks`), and each
chunk returns one int32 sum.

The entry points route as the JAX package's do: ``spgemm_counts`` to the
host engine at ``HOST_MAX_FLOPS``, the sliced-ELL executor while two
resident output arrays fit ``AUTO_ELL_MAX_SLOTS``, and the chunked ESC
engine otherwise or for an explicit ``chunk_flops``; the masked counts and
the triangle count to the ``masked=True`` ELL plan while it fits, else ESC.
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats.bcsr import BCSR
from ..utils.trace import span
from .spgemm import (
    DEFAULT_CHUNK_FLOPS,
    INT,
    INT32_MAX,
    _Prefetch,
    _indptr,
    _mask_tail,
    _pair_key,
    _prev,
    _row_ids,
    _running_max,
    _shr_logical,
    _sort,
    _sort_keys,
    _sort_tagged,
    _stitch_pipelined,
    _upload,
    expand_pairs,
    pad_bucket,
    pad_chunk_csr,
    packable,
    pull_padded_tuple,
    pull_prefix,
    require_int32_operands,
    resolve_device,
    row_flops,
    spgemm_flops,
    uniform_chunk_plan,
)

__all__ = [
    "masked_counts_compress",
    "masked_counts_compress_seps_2d",
    "masked_counts_compress_seps_2d_keys",
    "masked_counts_sum",
    "masked_counts_sum_2d",
    "masked_counts_sum_2d_keys",
    "masked_spgemm_counts",
    "sort_compress_counts",
    "sort_compress_counts_seps_2d",
    "sort_compress_counts_seps_2d_keys",
    "spgemm_counts",
    "triangle_count_device",
]

_LOW32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The counts compression
# ---------------------------------------------------------------------------


def _sort_payload(keys: torch.Tensor, payload: torch.Tensor):
    """``lax.sort((keys, payload), num_keys=1)`` along the last axis: the
    sorted keys and the payload in their order."""
    keys, perm = _sort(keys, dim=-1)
    return keys, torch.gather(payload, -1, perm)


def _counts_stage(key_s: torch.Tensor, valid: torch.Tensor, demote: int):
    """Compact sorted keys (``valid`` marks the non-sentinel slots) and count
    each kept key's run.  The exclusive running count ``q`` of valid slots
    rides the compaction sort, so a kept key's count is the next kept key's
    ``q`` minus its own (the last one closes against the total); slots past
    the kept prefix count 0.  Returns ``(compacted keys, counts int32,
    kept count)``; duplicates and invalid slots are demoted to ``demote``."""
    vi = valid.to(INT)
    q = torch.cumsum(vi, -1, dtype=INT) - vi
    total = vi.sum(-1, keepdim=True, dtype=INT)
    keep = (key_s != _prev(key_s, -1)) & valid
    nnz = keep.sum(-1, dtype=INT)
    c_keys, qc = _sort_payload(torch.where(keep, key_s, demote), q)
    mark = torch.arange(qc.shape[-1], dtype=INT, device=qc.device)
    n = nnz.unsqueeze(-1)
    nxt = torch.where(mark + 1 < n, torch.roll(qc, -1, -1), total)
    return c_keys, torch.where(mark < n, nxt - qc, 0), nnz


def _counts_compress(row, col, n_rows: int, n_cols: int, key=None):
    """The counts compression of ``(row, col)`` pairs along the last axis
    (``row == n_rows`` marks padding; separators ``(r, n_cols)`` survive as
    entries of count 1).  Packable pairs sort as the int32 key ``(row <<
    shift) | col`` (``key``, if the caller built it), the rest as the int64
    :func:`..spgemm._pair_key`.  Returns ``(rows, columns, counts, nnz)`` of
    the compacted stream; demoted slots sort past every kept one."""
    if packable(n_rows, n_cols):
        shift = int(n_cols).bit_length()
        if key is None:
            key = (row << shift) | col
        key_s = _sort_keys(key)
        c_keys, counts, nnz = _counts_stage(key_s, key_s < (n_rows << shift),
                                            INT32_MAX)
        return (_shr_logical(c_keys, shift), c_keys & ((1 << shift) - 1),
                counts, nnz)
    key_s = _sort(_pair_key(row, col), dim=-1).values
    c_keys, counts, nnz = _counts_stage(key_s, (key_s >> 32) < n_rows,
                                        (n_rows << 32) | n_cols)
    return c_keys >> 32, (c_keys & _LOW32).to(INT), counts, nnz


def sort_compress_counts(row, col, n_rows: int, n_cols: int):
    """``sort_compress`` that also returns each entry's multiplicity (int32:
    it is bounded by the inner dimension).  Returns ``(c_indptr, c_indices,
    c_counts, nnz_c)``; a stack of streams gives stacked results."""
    rows, cols, counts, nnz = _counts_compress(row, col, n_rows, n_cols)
    return _indptr(rows, n_rows), cols, counts, nnz


def sort_compress_counts_seps_2d_keys(key, n_rows: int, n_cols: int):
    """The packed branch of :func:`sort_compress_counts_seps_2d` on the
    pre-packed ``[k, L]`` key stream (separator keys included)."""
    _, cols, counts, nnz = _counts_compress(None, None, n_rows, n_cols, key=key)
    return cols, counts, nnz


def sort_compress_counts_seps_2d(row, col, n_rows: int, n_cols: int):
    """Batched :func:`sort_compress_counts` with embedded row separators:
    ``[k, L]`` streams, one ``(r, n_cols)`` separator per chunk row appended
    by the caller.  Each separator survives with a count of 1 that the host
    drops with it.  Returns ``(c_indices, c_counts, nnz)`` stacked, ``nnz``
    counting the separators."""
    _, cols, counts, nnz = _counts_compress(row, col, n_rows, n_cols)
    return cols, counts, nnz


# ---------------------------------------------------------------------------
# The masked counts: the counts compression, then a tagged join
# ---------------------------------------------------------------------------


def _masked_counts(row, col, f_row, f_col, n_rows: int, n_cols: int, *,
                   seps: bool, key=None):
    """C = F .* (A·B) with counts along the last axis: the counts
    compression, then a tagged join of the compacted entries against the
    mask pairs (mask first within an equal (row, col) run) with the counts
    riding as payload; with ``seps`` the ``(r, n_cols)`` separators survive
    the join unconditionally.  ``f_row``/``f_col`` are sentinel-masked
    already, and F is canonical.

    Where ``packable(n_rows, 2 * n_cols + 1)`` stage 1 demotes to
    ``INT32_MAX >> 1``, so the join key ``(u_key << 1) | 1`` stays inside
    int32; otherwise the join is :func:`..spgemm._sort_tagged`'s int64 key.
    Returns ``(columns, rows, counts, nnz)`` of the compacted stream."""
    if packable(n_rows, 2 * n_cols + 1):
        bl = int(n_cols).bit_length()
        shift, col_mask = bl + 1, (1 << bl) - 1
        if key is None:
            key = (row << bl) | col
        key_s = _sort_keys(key)
        u_keys, u_counts, _ = _counts_stage(key_s, key_s < (n_rows << bl),
                                            INT32_MAX >> 1)
        jk_s, jc_s = _sort_payload(
            torch.cat([(u_keys << 1) | 1, (f_row << shift) | (f_col << 1)], dim=-1),
            torch.cat([u_counts, torch.zeros_like(f_row)], dim=-1))
        is_cand = (jk_s & 1) == 1
        in_range = jk_s < ((n_rows << shift) | 1)
        keep = is_cand & (_prev(jk_s, -2) == (jk_s & ~1)) & in_range
        if seps:
            keep |= is_cand & in_range & ((_shr_logical(jk_s, 1) & col_mask) == n_cols)
        nnz = keep.sum(-1, dtype=INT)
        c_keys, counts = _sort_payload(torch.where(keep, jk_s, INT32_MAX),
                                       torch.where(keep, jc_s, 0))
        return (_shr_logical(c_keys, 1) & col_mask, _shr_logical(c_keys, shift),
                counts, nnz)
    u_rows, u_cols, u_counts, _ = _counts_compress(row, col, n_rows, n_cols)
    rs, cs, ts, ks = _sort_tagged([(u_rows, u_cols, 1), (f_row, f_col, 0)],
                                  n_rows, n_cols, 1,
                                  payload=torch.cat([u_counts, torch.zeros_like(f_row)],
                                                    dim=-1))
    in_range = rs < n_rows
    keep = ((ts == 1) & (rs == _prev(rs, -1)) & (cs == _prev(cs, -1))
            & (_prev(ts, 1) == 0) & in_range)
    if seps:
        keep |= (ts == 1) & (cs == n_cols) & in_range
    nnz = keep.sum(-1, dtype=INT)
    c_keys, counts = _sort_payload(
        torch.where(keep, _pair_key(rs, cs), (n_rows << 32) | n_cols),
        torch.where(keep, ks, 0))
    return (c_keys & _LOW32).to(INT), c_keys >> 32, counts, nnz


def masked_counts_compress(row, col, f_indptr, f_indices, f_nnz, n_rows: int,
                           n_cols: int):
    """Masked counts over an expanded candidate stream (the ESC and unrolled
    ELL engines feed theirs here): ``f_indices`` is padded, its slots at or
    past ``f_nnz`` ignored.  Returns ``(c_indptr, c_indices, c_counts,
    nnz_c)`` over ``len(row) + len(f_indices)`` slots; the valid entries
    never outnumber the mask's."""
    f_row = _row_ids(f_indptr, f_indices.shape[-1])
    f_row, f_col = _mask_tail(f_row, f_indices, f_nnz, n_rows, n_cols)
    cols, rows, counts, nnz = _masked_counts(row, col, f_row, f_col, n_rows,
                                             n_cols, seps=False)
    return _indptr(rows, n_rows), cols, counts, nnz


def masked_counts_compress_seps_2d_keys(key, f_row, f_col, n_rows: int, n_cols: int):
    """:func:`masked_counts_compress_seps_2d` on the pre-packed plain key
    stream ``(row << bl) | col`` (the caller checks ``packable(n_rows, 2 *
    n_cols + 1)``)."""
    cols, _, counts, nnz = _masked_counts(None, None, f_row, f_col, n_rows, n_cols,
                                          seps=True, key=key)
    return cols, counts, nnz


def masked_counts_compress_seps_2d(row, col, f_row, f_col, n_rows: int, n_cols: int):
    """Batched masked counts with embedded row separators: ``[k, L]``
    candidate streams and ``[k, Pf]`` sentinel-masked mask pairs joined
    along the last axis.  Returns ``(c_indices, c_counts, nnz)`` stacked,
    separators included (the host splits them off with their counts)."""
    cols, _, counts, nnz = _masked_counts(row, col, f_row, f_col, n_rows, n_cols,
                                          seps=True)
    return cols, counts, nnz


# ---------------------------------------------------------------------------
# The masked counts sum: one scalar per stream
# ---------------------------------------------------------------------------


def _masked_run_marks(is_mask: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """For each slot of a sorted tagged stream (last axis): does the latest
    (row, col)-run start at or before it hold a mask entry?  The latest run
    start is the running maximum of the run starts' positions, so it is a
    mask entry iff that maximum equals the running maximum of the mask run
    starts' positions (two scans over plain positions, no packed key).
    :func:`..spgemm._running_max` scans them, not ``torch.cummax``, whose
    scan of a long row is serial."""
    pos = torch.arange(is_mask.shape[-1], dtype=INT, device=is_mask.device)
    m_all = _running_max(torch.where(new, pos, -1))
    m_mask = _running_max(torch.where(new & is_mask, pos, -1))
    return (m_mask == m_all) & (m_all >= 0)


def _masked_counts_sum(row, col, f_row, f_col, n_rows: int, n_cols: int, key=None):
    """Sum over the mask entries (i, j) of the multiplicity of candidate
    pair (i, j), one int32 per stream along the last axis: one tagged sort
    (mask pairs first within an equal run), the run marks, and the count of
    marked candidates.  Separators ``(r, n_cols)`` match no mask pair."""
    packed = packable(n_rows, 2 * n_cols + 1)
    shift = int(n_cols).bit_length() + 1
    with span("sort"):
        if packed:
            if key is None:
                key = (row << (shift - 1)) | col
            # the joined stream is freed as the sort returns, before the marks
            key_s = _sort_keys(torch.cat([(key << 1) | 1,
                                          (f_row << shift) | (f_col << 1)], dim=-1))
        else:
            rs, cs, ts = _sort_tagged([(row, col, 1), (f_row, f_col, 0)],
                                      n_rows, n_cols, 1)
    with span("compress"):
        if packed:
            is_mask = (key_s & 1) == 0
            new = (key_s >> 1) != (_prev(key_s, -2) >> 1)
            in_range = key_s < (n_rows << shift)
        else:
            is_mask = ts == 0
            new = (rs != _prev(rs, -1)) | (cs != _prev(cs, -1))
            in_range = rs < n_rows
        counted = ~is_mask & _masked_run_marks(is_mask, new) & in_range
        return counted.sum(-1, dtype=INT)


def masked_counts_sum(row, col, f_indptr, f_indices, f_nnz, n_rows: int,
                      n_cols: int) -> torch.Tensor:
    """The masked counts sum of one candidate stream against padded CSR mask
    arrays (slots at or past ``f_nnz`` ignored): a 0-d int32 tensor, bounded
    by the stream's length."""
    f_row = _row_ids(f_indptr, f_indices.shape[-1])
    f_row, f_col = _mask_tail(f_row, f_indices, f_nnz, n_rows, n_cols)
    return _masked_counts_sum(row, col, f_row, f_col, n_rows, n_cols)


def masked_counts_sum_2d_keys(key, f_row, f_col, n_rows: int, n_cols: int):
    """:func:`masked_counts_sum_2d` on the pre-packed plain key stream; the
    tagged key is ``(key << 1) | 1``."""
    return _masked_counts_sum(None, None, f_row, f_col, n_rows, n_cols, key=key)


def masked_counts_sum_2d(row, col, f_row, f_col, n_rows: int, n_cols: int):
    """Batched :func:`masked_counts_sum`: one int32 sum per row of the
    ``[k, L]`` candidate stream, against ``[k, Pf]`` sentinel-masked mask
    pairs."""
    return _masked_counts_sum(row, col, f_row, f_col, n_rows, n_cols)


# ---------------------------------------------------------------------------
# ESC chunk programs
# ---------------------------------------------------------------------------


def _counts_padded(a_indptr, a_indices, a_nnz, b_indptr, b_indices, *,
                   n_cols: int, flops_pad: int, check_total: bool = True):
    """One ESC chunk of the counts product: ``(c_indptr, c_indices,
    c_counts, nnz_c)`` over ``flops_pad`` slots.  A ``flops_pad`` below the
    chunk's candidates raises (:func:`..spgemm.expand_pairs`)."""
    row, col = expand_pairs(a_indptr, a_indices, a_nnz, b_indptr, b_indices,
                            n_cols=n_cols, flops_pad=flops_pad,
                            check_total=check_total)
    return sort_compress_counts(row, col, a_indptr.shape[0] - 1, n_cols)


def _masked_counts_padded(f_indptr, f_indices, f_nnz, a_indptr, a_indices, a_nnz,
                          b_indptr, b_indices, *, n_cols: int, flops_pad: int,
                          check_total: bool = True):
    """One ESC chunk of C = F .* (A·B) with counts (the common-neighbour
    counts over the mask's support): ``(c_indptr, c_indices, c_counts,
    nnz_c)`` over ``flops_pad + len(f_indices)`` slots."""
    row, col = expand_pairs(a_indptr, a_indices, a_nnz, b_indptr, b_indices,
                            n_cols=n_cols, flops_pad=flops_pad,
                            check_total=check_total)
    return masked_counts_compress(row, col, f_indptr, f_indices, f_nnz,
                                  a_indptr.shape[0] - 1, n_cols)


def _masked_counts_sum_padded(f_indptr, f_indices, f_nnz, a_indptr, a_indices,
                              a_nnz, b_indptr, b_indices, *, n_cols: int,
                              flops_pad: int, check_total: bool = True):
    """One ESC chunk of the masked counts sum: a 0-d int32 tensor."""
    row, col = expand_pairs(a_indptr, a_indices, a_nnz, b_indptr, b_indices,
                            n_cols=n_cols, flops_pad=flops_pad,
                            check_total=check_total)
    return masked_counts_sum(row, col, f_indptr, f_indices, f_nnz,
                             a_indptr.shape[0] - 1, n_cols)


def _pull_counts(out):
    """One ESC chunk's ``(indptr, indices, counts, nnz)`` on the host, the
    indices and counts as their valid prefixes."""
    c_ptr, c_idx, c_cnt, nnz_c = out
    ptr, idx, k = pull_padded_tuple(c_ptr, c_idx, nnz_c)
    cnt = c_cnt.numpy()[:k] if isinstance(c_cnt, _Prefetch) else pull_prefix(c_cnt, k)
    return ptr, idx, cnt, k


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _check_counts_engine(engine: str, chunk_flops: int | None) -> None:
    if engine not in ("auto", "esc", "ell"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "ell" and chunk_flops is not None:
        raise ValueError(
            "engine='ell' is mutually exclusive with chunk_flops "
            "(explicit chunk_flops forces the ESC engine)"
        )


def _empty_counts(n: int, m: int) -> tuple[BCSR, np.ndarray]:
    return (BCSR(np.zeros(n + 1, np.int32), np.zeros(0, np.int32), (n, m)),
            np.zeros(0, np.int64))


def masked_spgemm_counts(
    f: BCSR,
    a: BCSR,
    b: BCSR,
    *,
    chunk_flops: int | None = None,
    engine: str = "auto",
    device: str | torch.device = "cuda",
) -> tuple[BCSR, np.ndarray]:
    """C = F .* (A·B) structure plus each entry's multiplicity (int64), mask
    first.  With ``f = a = b`` an undirected adjacency these are the
    per-edge common-neighbour counts.

    ``engine``: ``"auto"`` takes the ``masked=True`` sliced-ELL plan while
    its stream fits ``AUTO_ELL_MAX_SLOTS``, else the chunked ESC engine;
    ``"ell"`` forces ELL (raises ``OverflowError`` where it cannot plan);
    ``"esc"`` and an explicit ``chunk_flops`` force ESC.  The operands are
    canonicalised on the host first (duplicate entries would inflate the
    counts)."""
    _check_counts_engine(engine, chunk_flops)
    if a.n_cols != b.n_rows or tuple(f.shape) != (a.n_rows, b.n_cols):
        raise ValueError(f"shape mismatch: F{f.shape} vs {a.shape} @ {b.shape}")
    require_int32_operands(f, a, b)
    n, m = a.n_rows, b.n_cols
    if a.nnz == 0 or b.nnz == 0 or f.nnz == 0:
        return _empty_counts(n, m)
    f = f.sum_duplicates()
    a, b = a.sum_duplicates(), b.sum_duplicates()

    if chunk_flops is None and engine in ("auto", "ell"):
        from .ell import AUTO_ELL_MAX_SLOTS, cached_executor

        try:
            ex = cached_executor(a, b, masked=True, device=device)
            fits = ex.total_slots <= AUTO_ELL_MAX_SLOTS
        except OverflowError:
            if engine == "ell":
                raise
            ex, fits = None, False
        if fits or engine == "ell":
            return ex.assemble_counts(ex.run_masked_counts(f))

    device = resolve_device(device)
    rf = row_flops(a, b)
    # the join packs (row, col, tag bit): the row cap is that of the wider key
    chunks, rows_pad, nnz_pad, flops_pad = uniform_chunk_plan(
        a, rf, chunk_flops or DEFAULT_CHUNK_FLOPS, 2 * m + 1)
    f_nnz_pad = pad_bucket(max(int(f.indptr[r1] - f.indptr[r0]) for r0, r1 in chunks))
    b_indptr = _upload(b.indptr.astype(np.int32), device)
    b_indices = _upload(b.indices.astype(np.int32), device)

    def dispatch(r0, r1):
        ptr, idx, nnz_local = pad_chunk_csr(a, r0, r1, rows_pad, nnz_pad)
        f_ptr, f_idx, f_local = pad_chunk_csr(f, r0, r1, rows_pad, f_nnz_pad, fill=m)
        return _masked_counts_padded(
            _upload(f_ptr, device), _upload(f_idx, device), f_local,
            _upload(ptr, device), _upload(idx, device), nnz_local, b_indptr,
            b_indices, n_cols=m, flops_pad=flops_pad, check_total=False)

    return _stitch_pipelined(chunks, n, (n, m), dispatch, _pull_counts)


def spgemm_counts(
    a: BCSR,
    b: BCSR,
    *,
    chunk_flops: int | None = None,
    engine: str = "auto",
    device: str | torch.device = "cuda",
) -> tuple[BCSR, np.ndarray]:
    """C = A·B structure plus each entry's multiplicity: ``(c, counts)``
    with ``counts[k]`` (int64) the value of the integer product at
    ``c.indices[k]``.

    ``engine``: ``"auto"`` takes the host engine for products of at most
    ``HOST_MAX_FLOPS`` flops (on the host whatever ``device`` says), then
    the sliced-ELL plan while its two resident output arrays (indices and
    counts) fit ``AUTO_ELL_MAX_SLOTS``, else the chunked ESC engine;
    ``"ell"`` forces ELL (raises ``OverflowError`` where it cannot plan);
    ``"esc"`` and an explicit ``chunk_flops`` force ESC."""
    _check_counts_engine(engine, chunk_flops)
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
    require_int32_operands(a, b)
    n, m = a.n_rows, b.n_cols
    if a.nnz == 0 or b.nnz == 0:
        return _empty_counts(n, m)
    # duplicate operand entries would inflate the multiplicities
    a, b = a.sum_duplicates(), b.sum_duplicates()

    if chunk_flops is None and engine == "auto":
        from .host import HOST_MAX_FLOPS, host_spgemm_counts

        if spgemm_flops(a, b) <= HOST_MAX_FLOPS:
            return host_spgemm_counts(a, b)
    if chunk_flops is None and engine in ("auto", "ell"):
        from .ell import AUTO_ELL_MAX_SLOTS, cached_executor

        try:
            ex = cached_executor(a, b, device=device)
            # two resident output arrays (indices and counts): half the budget
            fits = ex.resident_slots <= AUTO_ELL_MAX_SLOTS // 2
        except OverflowError:
            if engine == "ell":
                raise
            ex, fits = None, False
        if fits or engine == "ell":
            return ex.assemble_counts(ex.run_counts())

    device = resolve_device(device)
    rf = row_flops(a, b)
    chunks, rows_pad, nnz_pad, flops_pad = uniform_chunk_plan(
        a, rf, chunk_flops or DEFAULT_CHUNK_FLOPS, m)
    b_indptr = _upload(b.indptr.astype(np.int32), device)
    b_indices = _upload(b.indices.astype(np.int32), device)

    def dispatch(r0, r1):
        ptr, idx, nnz_local = pad_chunk_csr(a, r0, r1, rows_pad, nnz_pad)
        return _counts_padded(
            _upload(ptr, device), _upload(idx, device), nnz_local, b_indptr,
            b_indices, n_cols=m, flops_pad=flops_pad, check_total=False)

    return _stitch_pipelined(chunks, n, (n, m), dispatch, _pull_counts)


def _triangles(total: int) -> int:
    if total % 6:
        raise ValueError(
            "edge-incident wedge sum not divisible by 6 — adjacency must be "
            "symmetric with an empty diagonal"
        )
    return total // 6


def triangle_count_device(
    a: BCSR, *, chunk_flops: int | None = None, device: str | torch.device = "cuda"
) -> int:
    """Triangles of the undirected simple graph whose (symmetric, hollow)
    adjacency is A: the sum over the entries (i, j) of A of the multiplicity
    of (A·A)[i, j], over 6.  Each chunk returns one int32 sum; the host adds
    them as int64.  Routes to the ``masked=True`` ELL plan while it fits
    ``AUTO_ELL_MAX_SLOTS``, else (or with ``chunk_flops``) to ESC.  Raises
    ``ValueError`` when the sum is not divisible by 6."""
    with span("call.triangle_count"):
        with span("call.check"):
            if a.n_rows != a.n_cols:
                raise ValueError("triangles need a square matrix")
            require_int32_operands(a)
            a = a.sum_duplicates()
        if a.nnz == 0:
            return 0
        n = a.n_rows

        if chunk_flops is None:
            from .ell import AUTO_ELL_MAX_SLOTS, cached_executor

            try:
                ex = cached_executor(a, a, masked=True, device=device)
            except OverflowError:
                ex = None
            if ex is not None and ex.total_slots <= AUTO_ELL_MAX_SLOTS:
                sums = ex.run_counts_sum(a)
                with span("sync.sums"):
                    sums = sums.cpu().numpy()
                # trailing dummy group-fill chunks sum to 0; drop them anyway
                return _triangles(int(sums[: ex.n_chunks].astype(np.int64).sum()))

        device = resolve_device(device)
        rf = row_flops(a, a)
        # (row, col, tag) packs into one key only under the wider masked bound
        chunks, rows_pad, nnz_pad, flops_pad = uniform_chunk_plan(
            a, rf, chunk_flops or DEFAULT_CHUNK_FLOPS, 2 * n + 1)
        f_nnz_pad = pad_bucket(max(int(a.indptr[r1] - a.indptr[r0]) for r0, r1 in chunks))
        b_indptr = _upload(a.indptr.astype(np.int32), device)
        b_indices = _upload(a.indices.astype(np.int32), device)
        total = torch.zeros((), dtype=torch.int64, device=device)
        for r0, r1 in chunks:
            ptr, idx, nnz_local = pad_chunk_csr(a, r0, r1, rows_pad, nnz_pad)
            f_ptr, f_idx, f_local = pad_chunk_csr(a, r0, r1, rows_pad, f_nnz_pad, fill=n)
            total += _masked_counts_sum_padded(
                _upload(f_ptr, device), _upload(f_idx, device), f_local,
                _upload(ptr, device), _upload(idx, device), nnz_local, b_indptr,
                b_indices, n_cols=n, flops_pad=flops_pad, check_total=False)
        with span("sync.total"):
            total = int(total)
        return _triangles(total)
