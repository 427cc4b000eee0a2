"""Row-partitioned closure and k-hop on one-sort rounds over a
``torch.distributed`` group.

Counterpart of ``binary_spgemm_tpu/parallel/dist_onesort.py``.  The
single-device form is :mod:`..ops.onesort`: each round R <- R OR R·R pays
one sort by carrying demoted duplicates as in-span holes.  Here the same
rounds run under the row partition (≡ the reference's ``SpGEMM_mpi``
decomposition, final/SpGEMM_mpi_omp.c:155-225, iterated to a fixpoint):

* rank r holds rows ``r*rows_per : (r+1)*rows_per`` of R as a padded column
  stream with holes and positional row pointers (equal rows, so every
  rank's pointer table has one shape), never compacted between rounds
  unless the holes pass :data:`ONESORT_COMPACT_RATIO`;
* each product gathers Y's stream and pointers from every rank (the
  replicated-B layout) and offsets the pointers into one global table, so
  the rank's expansion reaches any row's span (holes expand to sentinels);
* the closure's own stream joins as the fused-OR seed, one sort a rank a
  round, and :func:`.comm.all_reduce_sum` of the valid counts drives the
  fixpoint test.  Every rank takes the same sizes (the flop pad is the
  largest rank's bound, a compaction's pad the largest rank's count), so
  every rank leaves the loop at the same round.

==========================================  ==============================
JAX (``shard_map`` over the mesh)           here (one rank a shard)
==========================================  ==============================
``lax.all_gather`` of Y's stream and        one :func:`.comm.all_gather`
pointers                                    of both
``lax.psum`` of the valid counts            :func:`.comm.all_reduce_sum`
host ``np.max`` over the sharded bound      :func:`.comm.all_gather_host`
and nnz arrays                              of one scalar a rank
``_pull`` of the sharded arrays             each rank sends its valid
                                            entries and row counts; every
                                            rank stitches the full result
==========================================  ==============================

One repair: JAX's ``_dist_bound`` offsets Y's gathered pointers by X's
stream length (``e = cols.shape[1]``) where its product uses Y's, so
wherever a product joins streams of different lengths (``dist_k_hop`` at
k = 3, 5, ...) its bound comes out short and its expansion drops
candidates: JAX's A^3 lacks entries.  Here the bound uses Y's length, and
the expansion raises ``ValueError`` rather than truncate.
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats.bcsr import BCSR
from ..ops.graph import DEVICE_CLOSURE_MAX_FLOPS, ONESORT_COMPACT_RATIO, _power
from ..ops.onesort import _expand_from_padded, _sort_dedup_padded
from ..ops.spgemm import (
    INT,
    INT32_MAX,
    _pair_key,
    _row_ids,
    _upload,
    pad_bucket,
    require_int32_operands,
)
from . import comm
from .dist_spgemm import _mesh
from .mesh import RowMesh

__all__ = ["dist_transitive_closure", "dist_k_hop"]

# DEVICE_CLOSURE_MAX_FLOPS (the per-rank round budget) and
# ONESORT_COMPACT_RATIO are read from this module's names at call time, so
# a caller sets them here, as on the JAX package's module.

_LOW32 = 0xFFFFFFFF


def _stage(a: BCSR, mesh: RowMesh, rows_per: int, n_pad: int):
    """This rank's equal-rows shard of ``a``: its column stream padded with
    ``n_pad`` sentinels to the bucket of the largest shard (one length on
    every rank), its positional row pointers and its nnz (0-d int32), on
    the rank's device."""
    n = a.n_rows
    edges = np.minimum(np.arange(mesh.size + 1) * rows_per, n)
    e0 = pad_bucket(max(int(np.diff(a.indptr[edges]).max()), 1))
    r0, r1 = int(edges[mesh.rank]), int(edges[mesh.rank + 1])
    base = int(a.indptr[r0])
    seg = a.indices[base : a.indptr[r1]]
    cols = np.full(e0, n_pad, np.int32)
    cols[: len(seg)] = seg
    local = (a.indptr[r0 : r1 + 1] - base).astype(np.int32)
    pos = np.full(rows_per + 1, local[-1], np.int32)
    pos[: len(local)] = local
    dev = mesh.device
    return (_upload(cols, dev), _upload(pos, dev),
            torch.tensor(len(seg), dtype=INT, device=dev))


def _global_ptr(g_pos: torch.Tensor, e_y: int) -> torch.Tensor:
    """Every rank's positional pointers ``[S, rows_per+1]`` as one table over
    the ranks' streams laid end to end (rank s's at ``s * e_y``).  A rank's
    all-sentinel tail lands inside the span of its last row: dead slots,
    which expand to sentinels."""
    nd = g_pos.shape[0]
    if nd * e_y > INT32_MAX:
        raise OverflowError(f"gathered stream {nd}x{e_y} exceeds int32 addressing")
    offs = (torch.arange(nd, dtype=INT, device=g_pos.device) * e_y)[:, None]
    return torch.cat([(g_pos[:, :-1] + offs).reshape(-1), g_pos[-1, -1:] + offs[-1]])


def _dist_bound(xc: torch.Tensor, yp: torch.Tensor, e_y: int, mesh: RowMesh,
                n_pad: int) -> np.ndarray:
    """Every rank's padded-span flop bound of X·Y (int64, ``[S]``): the sum
    over the rank's valid X entries of Y's global row span.  ``xc`` is this
    rank's X stream, ``yp`` its Y pointers, ``e_y`` Y's stream length (the
    JAX package offsets by X's length here, which undercounts where the
    two differ)."""
    gp = _global_ptr(comm.all_gather(yp, mesh), e_y)
    valid = xc < n_pad
    acol = torch.where(valid, xc, 0)
    span = torch.where(valid, torch.index_select(gp, 0, acol + 1)
                       - torch.index_select(gp, 0, acol), 0)
    mine = span.sum(dtype=torch.int64).reshape(1)
    return comm.all_gather_host(mine, mesh).numpy()[:, 0]


def _guarded_pad(x, y, mesh: RowMesh, n_pad: int) -> int:
    """The flop pad of one X·Y product, the largest rank's bound (so every
    rank allocates alike), raising ``OverflowError`` past the per-rank
    resident budget."""
    worst = int(_dist_bound(x[0], y[1], y[0].shape[0], mesh, n_pad).max())
    if worst > 0.98 * DEVICE_CLOSURE_MAX_FLOPS:
        raise OverflowError(
            f"a rank's padded round bound {worst} exceeds the resident budget "
            f"{DEVICE_CLOSURE_MAX_FLOPS}; use the host path or more ranks"
        )
    return pad_bucket(max(worst, 8))


def _dist_product(x, y, mesh: RowMesh, *, flops_pad: int, seed: bool, n_pad: int):
    """One one-sort product round: this rank's rows of X·Y (X local, Y
    gathered from every rank), with ``seed`` OR-seeded by X's own stream
    (the closure round R <- R OR R·R is ``seed=True`` with X = Y = R).
    Returns the rank's next ``(cols, pos, nnz)`` state and the group's
    valid count."""
    (xc, xp, _), (yc, yp, _) = x, y
    e_y, rows_per = yc.shape[0], xp.shape[0] - 1
    g = comm.all_gather(torch.cat([yc, yp]), mesh)
    row, col = _expand_from_padded(xc, xp, g[:, :e_y].reshape(-1),
                                   _global_ptr(g[:, e_y:], e_y), n_cols=n_pad,
                                   flops_pad=flops_pad)
    if seed:
        # the fused-OR D-seed: the rank's own stream joins as it is
        valid = xc < n_pad
        row = torch.cat([row, torch.where(valid, _row_ids(xp, xc.shape[0]), rows_per)])
        col = torch.cat([col, torch.where(valid, xc, n_pad)])
    cols, pos, nnz = _sort_dedup_padded(row, col, rows_per, n_pad)
    total = comm.all_reduce_sum(nnz.to(torch.int64).reshape(1), mesh)
    return (cols, pos, nnz), int(total[0])


def _dist_compact(state, *, pad_to: int, n_pad: int):
    """The between-round hole compaction of this rank's stream: one sort
    (an int64 ``(row << 32) | col`` key for JAX's two-key sort) squeezes it
    to ``pad_to`` slots (the caller sizes ``pad_to`` past the largest
    rank's valid count)."""
    cols, pos, nnz = state
    rows_per = pos.shape[0] - 1
    valid = cols < n_pad
    rows = torch.where(valid, _row_ids(pos, cols.shape[0]), rows_per)
    key = torch.sort(_pair_key(rows, torch.where(valid, cols, n_pad))).values
    head = key[:pad_to]
    out_c = torch.where((head >> 32) < rows_per, (head & _LOW32).to(INT), n_pad)
    bounds = torch.arange(rows_per + 1, dtype=torch.int64, device=cols.device)
    out_p = torch.searchsorted(key >> 32, bounds).clamp_(max=pad_to).to(INT)
    return out_c, out_p, nnz


def _regate(state, mesh: RowMesh, n_pad: int):
    """Between rounds: compact every rank once the common stream length
    outruns the largest rank's valid count by :data:`ONESORT_COMPACT_RATIO`
    (one gather of the counts)."""
    cols, _, nnz = state
    largest = max(int(comm.all_gather_host(nnz.reshape(1), mesh).max()), 1)
    if cols.shape[0] > ONESORT_COMPACT_RATIO * largest:
        return _dist_compact(state, pad_to=pad_bucket(largest), n_pad=n_pad)
    return state


def _pull(state, n: int, mesh: RowMesh, rows_per: int, n_pad: int) -> BCSR:
    """The full ``(n, n)`` result on every rank: each rank drops its holes
    on its device and sends its row counts and valid columns (padded to
    the longest rank's) in one gather; the row blocks stack in rank order
    (rows past ``n`` are empty)."""
    cols, pos, _ = state
    keep = cols < n_pad
    before = torch.cat([torch.zeros(1, dtype=INT, device=cols.device),
                        torch.cumsum(keep, 0, dtype=INT)])
    at = torch.index_select(before, 0, pos)
    row_nnz = at[1:] - at[:-1]
    valid = cols[keep]
    width = int(comm.all_gather_host(torch.tensor([valid.shape[0]]), mesh).max())
    payload = torch.full((rows_per + width,), n_pad, dtype=INT, device=cols.device)
    payload[:rows_per] = row_nnz
    payload[rows_per : rows_per + valid.shape[0]] = valid
    g = comm.all_gather_host(payload, mesh).numpy()
    counts = g[:, :rows_per].astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts.reshape(-1)[:n], out=indptr[1:])
    indices = np.concatenate([g[s, rows_per : rows_per + int(counts[s].sum())]
                              for s in range(mesh.size)])
    return BCSR(indptr, indices, (n, n))


def _setup(a: BCSR, mesh, device):
    require_int32_operands(a)
    a = a.sum_duplicates()
    mesh = _mesh(mesh, device)
    rows_per = -(-a.n_rows // mesh.size)
    return a, mesh, rows_per, rows_per * mesh.size


def dist_transitive_closure(
    a: BCSR,
    mesh: RowMesh | None = None,
    *,
    max_iters: int | None = None,
    device: str | torch.device = "cuda",
) -> BCSR:
    """Reachability closure over the ranks of ``mesh`` (this process alone
    when ``None``, on ``device``) on one-sort rounds; every rank gets the
    full result.  Semantics ≡ :func:`..ops.graph.transitive_closure`; the
    decomposition ≡ the reference's row partition iterated to the
    fixpoint.  Raises ``OverflowError`` where a rank's round bound passes
    the per-rank resident budget."""
    if a.n_rows != a.n_cols:
        raise ValueError("closure needs a square matrix")
    a, mesh, rows_per, n_pad = _setup(a, mesh, device)
    state = _stage(a, mesh, rows_per, n_pad)
    iters = max_iters if max_iters is not None else max(1, a.n_rows.bit_length())
    prev_total = a.nnz
    for _ in range(iters):
        flops_pad = _guarded_pad(state, state, mesh, n_pad)
        state, total = _dist_product(state, state, mesh, flops_pad=flops_pad, seed=True,
                                     n_pad=n_pad)
        if total == prev_total:
            break
        prev_total = total
        state = _regate(state, mesh, n_pad)
    return _pull(state, a.n_rows, mesh, rows_per, n_pad)


def dist_k_hop(a: BCSR, mesh: RowMesh | None, k: int, *,
               device: str | torch.device = "cuda") -> BCSR:
    """The structure of A^k over the ranks of ``mesh`` (this process alone
    when ``None``, on ``device``), by binary exponentiation as
    :func:`..ops.graph.k_hop`; each product keeps X row-sharded, gathers
    Y's uncompacted stream and pays one sort a rank.  Every rank gets the
    full result.  Unlike the JAX package's, exact where a product joins
    streams of different lengths (k = 3, 5, ...; see the module
    docstring)."""
    if k < 1:
        raise ValueError("k must be >= 1")
    if a.n_rows != a.n_cols:
        raise ValueError("k-hop needs a square matrix")
    a, mesh, rows_per, n_pad = _setup(a, mesh, device)

    def prod(x, y):
        out, _ = _dist_product(x, y, mesh, flops_pad=_guarded_pad(x, y, mesh, n_pad),
                               seed=False, n_pad=n_pad)
        return _regate(out, mesh, n_pad)

    result = _power(_stage(a, mesh, rows_per, n_pad), k, prod)
    return _pull(result, a.n_rows, mesh, rows_per, n_pad)
