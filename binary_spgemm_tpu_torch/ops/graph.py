"""Graph algorithms over the boolean SpGEMM core.

Counterpart of ``binary_spgemm_tpu/ops/graph.py``: k-hop reachability,
transitive closure, BFS levels, triangle structure and counts, clustering
coefficients and the k-truss, each a chain of the port's products.

``device=`` is the torch device everywhere, ``"cuda"`` unless told
otherwise.  The JAX package's boolean ``device=`` flag of ``k_hop`` /
``transitive_closure`` (keep the running matrices in HBM) is ``resident=``
here, and ``triangle_count``'s (the counting kernel rather than the scipy
oracle) is ``resident=`` too; the defaults are JAX's.  ``k_truss`` has no
such flag in the JAX package: its ``resident=True`` (the default) is the
device-resident peel of :mod:`.truss`, ``resident=False`` the JAX
package's host loop.

``k_hop`` and ``transitive_closure`` run on three routes:

* host (``resident=False``): each product is a one-shot :func:`..spgemm.spgemm`
  / :func:`..fused.spgemm_or`, routed as those route (the host engine for
  small products, the sliced-ELL executors with their hand kernels, ESC);
* resident compacted (``resident=True, one_sort=False``):
  :class:`..spgemm.DeviceBCSR` operands through ``ops/device_api.py``, one
  ``compact()`` between rounds;
* resident one-sort (``resident=True``, the default there):
  :class:`..onesort.PaddedDeviceBCSR` streams with holes, one sort a round,
  compacted only when the holes pass :data:`ONESORT_COMPACT_RATIO`.

The resident routes read two scalars a round on the host (the flop bound
and the result's nnz) and raise ``OverflowError`` past
:data:`DEVICE_CLOSURE_MAX_FLOPS`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats.bcsr import BCSR
from .counts import masked_spgemm_counts, triangle_count_device
from .device_api import _row_lengths, spgemm_device, spgemm_or_device
from .fused import spgemm_or
from .masked import masked_spgemm
from .onesort import (
    PaddedDeviceBCSR,
    flops_bound_onesort,
    spgemm_onesort_device,
    spgemm_or_onesort_device,
)
from .spgemm import INT, DeviceBCSR, pad_bucket, require_int32_operands, spgemm
from .truss import k_truss_device

__all__ = [
    "DEVICE_CLOSURE_MAX_FLOPS",
    "ONESORT_COMPACT_RATIO",
    "bfs_levels",
    "clustering_coefficients",
    "k_hop",
    "k_truss",
    "reachable",
    "transitive_closure",
    "triangle_count",
    "triangle_structure",
]

# Flop-bound cap of one resident whole-matrix step (verbatim from the JAX
# package): 2^28 candidate slots.  A resident round's peak holds the
# expansion's int32 temporaries, the int64 sort keys and torch.sort's values
# and int64 indices: 68-85 bytes a slot at 65,536 rows (chip_smoke.py phase
# 19 on an NVIDIA H100 80GB HBM3, PERF.md), so 17-21 GiB at the cap.
DEVICE_CLOSURE_MAX_FLOPS = 1 << 28

# Compact a one-sort stream between rounds once holes push its length past
# this multiple of its valid count (verbatim from the JAX package).  A
# one-sort round sorts (flops·h + stream) slots against the compacted
# pipeline's 2·(flops + nnz_d); with hole ratio h = stream/nnz the one-sort
# round is cheaper while h is below about 2, and a compaction costs one
# stream-length sort.
ONESORT_COMPACT_RATIO = 2.0


def _overflow(est: float, what: str, fallback: str) -> OverflowError:
    return OverflowError(
        f"{what} flop bound ~{est:.3g} exceeds the resident budget "
        f"{DEVICE_CLOSURE_MAX_FLOPS}; use the chunked host path ({fallback})"
    )


def _guarded_flops_pad(x: DeviceBCSR, y: DeviceBCSR) -> int:
    """The flop-bound pad of one resident product x·y, raising past the
    whole-matrix budget (the resident k-hop and closure loops).  The guard
    reads a float32 sum, which does not wrap as the int32 sum can."""
    blen = _row_lengths(x, y)
    fb, est = blen.sum(dtype=INT), blen.to(torch.float32).sum()
    if float(est) > 0.98 * DEVICE_CLOSURE_MAX_FLOPS:
        raise _overflow(float(est), "product", "resident=False")
    return pad_bucket(max(int(fb), 8))


def _onesort_guarded_pad(r, s) -> int:
    """The padded-span flop-bound pad of one one-sort product r·s, raising
    past the resident budget."""
    fb, est = flops_bound_onesort(r, s)
    if float(est) > 0.98 * DEVICE_CLOSURE_MAX_FLOPS:
        raise _overflow(float(est), "padded product",
                        "resident=False, or one_sort=False")
    return pad_bucket(max(int(fb), 8))


def _onesort_regate(r: PaddedDeviceBCSR) -> PaddedDeviceBCSR:
    """Between rounds: one compaction sort once the stream has grown past
    :data:`ONESORT_COMPACT_RATIO` times its valid count."""
    if r.stream_len > ONESORT_COMPACT_RATIO * max(int(r.nnz), 1):
        return PaddedDeviceBCSR.from_device(r.compact())
    return r


def _power(a, k: int, prod):
    """A^k by binary exponentiation with the product ``prod``."""
    result, power = None, a
    while k:
        if k & 1:
            result = power if result is None else prod(result, power)
        k >>= 1
        if k:
            power = prod(power, power)
    return result


def k_hop(
    a: BCSR,
    k: int,
    *,
    chunk_flops: int | None = None,
    resident: bool = False,
    one_sort: bool = True,
    device: str | torch.device = "cuda",
) -> BCSR:
    """Structure of A^k, by binary exponentiation (about log2(k) products).

    ``resident=True`` (the JAX package's ``device=True``) keeps the running
    power and result on ``device`` between products and raises
    ``OverflowError`` past the resident budget; ``one_sort`` (resident only,
    on by default) chains the products through uncompacted streams
    (:mod:`.onesort`), ``False`` takes the compacted rounds."""
    if k < 1:
        raise ValueError("k must be >= 1")
    if resident:
        require_int32_operands(a)
        if one_sort:
            return _k_hop_device_onesort(a, k, device)
        return _k_hop_device(a, k, device)
    return _power(a.sum_duplicates(), k,
                  lambda x, y: spgemm(x, y, chunk_flops=chunk_flops, device=device))


def _k_hop_device(a: BCSR, k: int, device) -> BCSR:
    def prod(x, y):
        return spgemm_device(x, y, flops_pad=_guarded_flops_pad(x, y)).compact()

    return _power(DeviceBCSR.from_host(a.sum_duplicates(), device=device), k,
                  prod).to_host()


def _k_hop_device_onesort(a: BCSR, k: int, device) -> BCSR:
    def prod(x, y):
        return _onesort_regate(
            spgemm_onesort_device(x, y, flops_pad=_onesort_guarded_pad(x, y)))

    return _power(PaddedDeviceBCSR.from_host(a.sum_duplicates(), device=device), k,
                  prod).to_host()


def transitive_closure(
    a: BCSR,
    *,
    max_iters: int | None = None,
    chunk_flops: int | None = None,
    resident: bool = False,
    one_sort: bool = True,
    device: str | torch.device = "cuda",
) -> BCSR:
    """Reachability closure: the OR of A, A², A⁴, ... to the fixpoint, by
    the doubling round R <- R OR R·R (about log2(diameter) rounds).

    ``resident=True`` (the JAX package's ``device=True``) keeps R on
    ``device`` between rounds: the host reads two scalars a round instead of
    pulling each intermediate.  ``one_sort`` (on by default) runs those
    rounds on uncompacted streams with holes (:mod:`.onesort`), one sort a
    round, compacting only past :data:`ONESORT_COMPACT_RATIO`;
    ``one_sort=False`` takes the compacted rounds.  The resident routes
    raise ``OverflowError`` when a round's flop bound passes the resident
    budget."""
    if a.n_rows != a.n_cols:
        raise ValueError("closure needs a square matrix")
    iters = max_iters if max_iters is not None else max(1, a.n_rows.bit_length())
    if resident:
        require_int32_operands(a)
        if one_sort:
            return _transitive_closure_device_onesort(a, iters, device)
        return _transitive_closure_device(a, iters, device)
    r = a.sum_duplicates()
    for _ in range(iters):
        # one fused pass a round: the union rides the product's sort
        nxt = spgemm_or(r, r, r, chunk_flops=chunk_flops, device=device)
        if nxt.nnz == r.nnz and nxt.equals(r):
            return r
        r = nxt
    return r


def _resident_closure(r, iters: int, step, regate):
    """The resident doubling loop: R OR R·R is a superset of R, so an equal
    nnz is the fixpoint."""
    prev_nnz = int(r.nnz)
    for _ in range(iters):
        nxt = step(r)
        nnz = int(nxt.nnz)
        if nnz == prev_nnz:
            break
        prev_nnz = nnz
        r = regate(nxt)
    return r.to_host()


def _transitive_closure_device(a: BCSR, iters: int, device) -> BCSR:
    return _resident_closure(
        DeviceBCSR.from_host(a.sum_duplicates(), device=device), iters,
        lambda r: spgemm_or_device(r, r, r, flops_pad=_guarded_flops_pad(r, r)),
        lambda r: r.compact())


def _transitive_closure_device_onesort(a: BCSR, iters: int, device) -> BCSR:
    return _resident_closure(
        PaddedDeviceBCSR.from_host(a.sum_duplicates(), device=device), iters,
        lambda r: spgemm_or_onesort_device(r, r, r,
                                           flops_pad=_onesort_guarded_pad(r, r)),
        _onesort_regate)


def clustering_coefficients(
    a: BCSR, *, chunk_flops: int | None = None, device: str | torch.device = "cuda"
) -> np.ndarray:
    """Local clustering coefficient of each node of the undirected simple
    graph with (symmetric, hollow) adjacency A: triangles at v over C(deg v,
    2), from the per-edge common-neighbour counts
    (:func:`..counts.masked_spgemm_counts` with F = A = B); nodes of degree
    below 2 get 0.  Returns float64[n]."""
    if a.n_rows != a.n_cols:
        raise ValueError("clustering needs a square adjacency matrix")
    a = a.sum_duplicates()
    c, counts = masked_spgemm_counts(a, a, a, chunk_flops=chunk_flops, device=device)
    rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(c.indptr))
    tri2 = np.zeros(a.n_rows, np.int64)  # 2 * triangles at v
    np.add.at(tri2, rows, counts)
    deg = np.diff(a.indptr).astype(np.int64)
    pairs = deg * (deg - 1)  # 2 * C(deg, 2)
    out = np.zeros(a.n_rows, np.float64)
    nz = pairs > 0
    out[nz] = tri2[nz] / pairs[nz]
    return out


def k_truss(
    a: BCSR, k: int, *, chunk_flops: int | None = None, resident: bool = True,
    device: str | torch.device = "cuda",
) -> BCSR:
    """The k-truss of the undirected simple graph with (symmetric, hollow)
    adjacency A: the largest subgraph whose every edge lies in at least k-2
    of its triangles, by the synchronous peel (every round drops all the
    edges below k-2 at once, until nothing drops).

    ``resident=True`` (the default) peels on ``device``
    (:func:`..truss.k_truss_device`: the graph a live mask over A's entries
    on A's cached masked plan, or ESC where that does not fit or
    ``chunk_flops`` is given; one device read a round, the result pulled
    once).  ``resident=False`` is the host loop, each round's per-edge
    common-neighbour counts (:func:`..counts.masked_spgemm_counts`, F = G =
    G) and a new host graph.  Both give the same canonical CSR."""
    if resident:
        return k_truss_device(a, k, chunk_flops=chunk_flops, device=device)
    if k < 3:
        raise ValueError("k-truss needs k >= 3")
    if a.n_rows != a.n_cols:
        raise ValueError("k-truss needs a square adjacency matrix")
    g = a.sum_duplicates()
    need = k - 2
    while g.nnz:
        c, counts = masked_spgemm_counts(g, g, g, chunk_flops=chunk_flops,
                                         device=device)
        # edges of g absent from c have support 0
        rows, cols = c.to_coo()
        keep = counts >= need
        nxt = BCSR.from_coo(rows[keep], cols[keep], g.shape)
        if nxt.nnz == g.nnz:
            return g
        g = nxt
    return g


def bfs_levels(
    a: BCSR,
    sources,
    *,
    max_hops: int | None = None,
    chunk_flops: int | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """BFS hop levels from a source set over the directed graph with
    adjacency A (edge i -> j where A[i, j] is set): ``int32[n]``, 0 at the
    sources, k at a node first reached after k frontier expansions, -1 where
    unreachable.  Each round multiplies the frontier (a 1 x n pattern row)
    by A through :func:`..spgemm.spgemm` and the host keeps the columns
    never seen, so every edge is traversed once in the whole search."""
    if a.n_rows != a.n_cols:
        raise ValueError("bfs needs a square adjacency matrix")
    n = a.n_rows
    src = np.unique(np.atleast_1d(np.asarray(sources, dtype=np.int64)))
    if src.size == 0:
        raise ValueError("sources must be non-empty")
    if src[0] < 0 or src[-1] >= n:
        raise ValueError(f"source ids must be in [0, {n}); got {sources!r}")
    level = np.full(n, -1, dtype=np.int32)
    level[src] = 0
    frontier = src.astype(np.int32)  # ascending and unique: canonical
    hops = n if max_hops is None else max_hops
    lvl = 0
    while frontier.size and lvl < hops:
        lvl += 1
        f = BCSR(np.array([0, frontier.size], dtype=np.int32), frontier, (1, n))
        cand = spgemm(f, a, chunk_flops=chunk_flops, device=device).indices
        frontier = cand[level[cand] < 0]
        level[frontier] = lvl
    return level


def reachable(
    a: BCSR,
    sources,
    *,
    max_hops: int | None = None,
    chunk_flops: int | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Sorted ids of the nodes reachable from the source set (sources
    included), within ``max_hops`` edge traversals if given."""
    lv = bfs_levels(a, sources, max_hops=max_hops, chunk_flops=chunk_flops,
                    device=device)
    return np.flatnonzero(lv >= 0).astype(np.int32)


def triangle_structure(
    a: BCSR, *, chunk_flops: int | None = None, device: str | torch.device = "cuda"
) -> BCSR:
    """The edges (i, j) of A that close at least one triangle: A .* (A·A)."""
    if a.n_rows != a.n_cols:
        raise ValueError("triangles need a square matrix")
    return masked_spgemm(a, a, a, chunk_flops=chunk_flops, device=device)


def triangle_count(
    a: BCSR,
    *,
    chunk_flops: int | None = None,
    resident: bool = True,
    device: str | torch.device = "cuda",
) -> int:
    """Triangles of the undirected simple graph with adjacency A (symmetric,
    empty diagonal): the sum over the entries (i, j) of A of |N(i) ∩ N(j)|,
    over 6.  ``resident=True`` (the JAX package's ``device=True``, the
    default) runs the masked counting kernel on ``device``
    (:func:`..counts.triangle_count_device`: one scalar a chunk leaves the
    device); ``resident=False`` is the scipy oracle on the host."""
    if resident:
        return triangle_count_device(a, chunk_flops=chunk_flops, device=device)
    sp = a.to_scipy().astype(np.int64)
    return int((sp @ sp).multiply(sp).sum()) // 6
