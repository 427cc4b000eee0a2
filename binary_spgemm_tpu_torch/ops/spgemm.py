"""Expand–sort–compress building blocks the sliced-ELL engines use.

Counterpart of ``binary_spgemm_tpu/ops/spgemm.py``, the subset the ported
routes need: the padding and packing rules, host flop counts, the
contiguous row chunking, the 2-D sort–dedup–compact step with embedded row
separators (each row of it is the JAX package's 1-D step of one chunk), the
pull of each chunk's valid prefix to the host,
the one-shot :func:`spgemm` with its routing, and the opt-in
:func:`blocked_route`.  Candidate ``(row, col)`` pairs pack into one
non-negative int32 key ``(row << shift) | col`` when :func:`packable` holds;
the packed step sorts through :func:`..bitonic.sort_rows` (K1 up to its
longest row, ``torch.sort`` past it).
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats.bcsr import BCSR
from .bitonic import sort_rows as sort_rows_1key

__all__ = [
    "COMPACT_PULL_BYTES",
    "blocked_route",
    "compact_chunks",
    "compact_pull",
    "pad_bucket",
    "packable",
    "pull_chunk_prefixes",
    "require_int32_operands",
    "resolve_device",
    "row_flops",
    "sort_compress_seps_2d",
    "sort_compress_seps_2d_keys",
    "split_seps",
    "spgemm_flops",
]

INT = torch.int32
INT32_MAX = (1 << 31) - 1


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


def sort_compress_seps_2d_keys(
    key: torch.Tensor, n_rows: int, n_cols: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each row of the packed ``[k, L]`` key stream, drop left-neighbour
    duplicates and keys at or past the sentinel row, compact by demoting them
    to ``INT32_MAX`` and sorting again.  Returns the column field of the
    compacted keys (separators embedded, so each chunk's row pointers ride in
    the stream) and the per-row valid count ``nnz [k]`` (int32)."""
    k = key.shape[0]
    shift = int(n_cols).bit_length()
    limit = n_rows << shift
    key_s = sort_rows_1key(key)
    prev = torch.cat(
        [torch.full((k, 1), -1, dtype=INT, device=key.device), key_s[:, :-1]],
        dim=1,
    )
    keep = (key_s != prev) & (key_s < limit)
    nnz_c = keep.sum(dim=1, dtype=INT)
    demoted = torch.where(keep, key_s, INT32_MAX)
    c_keys = sort_rows_1key(demoted)
    return c_keys & ((1 << shift) - 1), nnz_c


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
    k = row.shape[0]
    key = (row.to(torch.int64) << 32) | col.to(torch.int64)
    key_s = torch.sort(key, dim=1).values
    prev = torch.cat(
        [torch.full((k, 1), -1, dtype=torch.int64, device=key.device),
         key_s[:, :-1]],
        dim=1,
    )
    keep = (key_s != prev) & ((key_s >> 32) < n_rows)
    nnz_c = keep.sum(dim=1, dtype=INT)
    demoted = torch.where(keep, key_s, (n_rows << 32) | n_cols)
    c_keys = torch.sort(demoted, dim=1).values
    return (c_keys & 0xFFFFFFFF).to(INT), nnz_c


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


def row_flops(a: BCSR, b: BCSR) -> np.ndarray:
    """Per-output-row Gustavson flop counts of A·B (host, vectorised)."""
    blen = np.diff(b.indptr).astype(np.int64)
    per_entry = blen[a.indices] if a.nnz else np.zeros(0, np.int64)
    cum = np.zeros(a.nnz + 1, dtype=np.int64)
    np.cumsum(per_entry, out=cum[1:])
    return cum[a.indptr[1:]] - cum[a.indptr[:-1]]


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


def _pull_prefix(flat: torch.Tensor, total: int) -> np.ndarray:
    """``flat[:total]`` on the host."""
    if total <= 0:
        return np.zeros(0, np.int32)
    return flat[:total].cpu().numpy()


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
        return [_pull_prefix(idx.reshape(-1), total)]
    nnz = torch.from_numpy(np.asarray(nnz_valid, np.int32)).to(idx.device)
    host = _pull_prefix(compact_chunks(idx, nnz), total)
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


def _stitch(chunks, rows_total, shape, run_chunk) -> BCSR:
    """Run ``run_chunk(r0, r1) -> (c_ptr, c_idx, nnz_c)`` per contiguous row
    chunk and stitch the slices with a row-pointer prefix fix.  Chunk-local
    pointers are int32; the host bases are int64, so the stitched indptr
    widens once the total passes the int32 domain."""
    indptr_parts = [np.zeros(1, np.int64)]
    index_parts = []
    base = 0
    for r0, r1 in chunks:
        c_ptr, c_idx, nnz_c = run_chunk(r0, r1)
        nnz_c = int(nnz_c)
        index_parts.append(np.asarray(c_idx[:nnz_c]))
        local = np.asarray(c_ptr[1 : r1 - r0 + 1], dtype=np.int64)
        indptr_parts.append(local + base)
        base += nnz_c
    indptr = np.concatenate(indptr_parts)
    indices = (
        np.concatenate(index_parts) if index_parts else np.zeros(0, np.int32)
    )
    return BCSR(indptr, indices, shape)


# A single output row past this many flops takes the JAX package's
# column-windowed route (``_spgemm_giant``), not ported yet.
GIANT_ROW_FLOPS = 1 << 30


def spgemm(
    a: BCSR,
    b: BCSR,
    *,
    chunk_flops: int | None = None,
    device: str | torch.device = "cuda",
) -> BCSR:
    """Boolean SpGEMM structure C = A·B, one shot, on ``device``.

    Routes as the JAX package's ``spgemm`` does: products of at most
    ``HOST_MAX_FLOPS`` flops take the host engine (:func:`..host.host_spgemm`,
    on the host whatever ``device`` says); the rest go through
    :func:`..ell.cached_executor` with ``allow_bsr=True``, which serves the
    blocked route (block-clustered operands) and the sliced-ELL plans
    (batched, or unrolled below 2^16 rows and past the skew guard).  The
    routes not ported raise ``NotImplementedError``: giant rows, an explicit
    ``chunk_flops``, and products past the resident ELL budget or the int32
    slot domain (the last three are the JAX package's ESC engine)."""
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
    require_int32_operands(a, b)
    n, m = a.n_rows, b.n_cols
    if a.nnz == 0 or b.nnz == 0:
        return BCSR(np.zeros(n + 1, np.int32), np.zeros(0, np.int32), (n, m))
    rf_total = row_flops(a, b)
    if len(rf_total) and int(rf_total.max()) > GIANT_ROW_FLOPS:
        raise NotImplementedError(
            "rows past GIANT_ROW_FLOPS take the column-windowed route, "
            "which is not ported yet (ROADMAP.md, Queue 1 item 1)"
        )
    if chunk_flops is not None:
        raise NotImplementedError(
            "chunk_flops selects the chunked ESC engine, which is not "
            "ported yet (ROADMAP.md, Queue 1 item 1)"
        )
    # small-flop products cost less on the host than one device round trip
    from .host import HOST_MAX_FLOPS, host_spgemm

    if int(rf_total.sum()) <= HOST_MAX_FLOPS:
        return host_spgemm(a, b)
    from .ell import AUTO_ELL_MAX_SLOTS, cached_executor

    esc = ("the JAX package takes the chunked ESC engine, which is not "
           "ported yet (ROADMAP.md, Queue 1 item 1)")
    # block-clustered products take the staged blocked engine; repeated
    # calls on the same operands reuse the staged tiles through the cache
    try:
        ex = cached_executor(a, b, allow_bsr=True, device=device)
    except OverflowError as err:
        raise NotImplementedError(f"{err}: {esc}") from err
    if getattr(ex, "engine", None) == "bsr":
        return ex.assemble(ex.run())
    if ex.resident_slots > AUTO_ELL_MAX_SLOTS:
        raise NotImplementedError(f"past the resident ELL budget {esc}")
    return ex.assemble(ex.run())
