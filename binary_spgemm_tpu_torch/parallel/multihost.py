"""Multi-process (multi-node) glue.

Counterpart of ``binary_spgemm_tpu/parallel/multihost.py``.  The reference
reaches several nodes through ``mpirun``/``srun`` and MPI collectives
(final/SpGEMM_mpi_omp.c:346-366); the JAX package through
``jax.distributed``; here one process a rank, joined in one
``torch.distributed`` group (``torchrun``, or :mod:`.launch` on one
machine), running the same per-rank steps as :mod:`.dist_spgemm`.

Usage in every process::

    from binary_spgemm_tpu_torch.parallel import multihost
    multihost.initialize()                 # env:// (torchrun sets it up)
    mesh = multihost.global_row_mesh()
    a = read_pattern(path)                 # replicated ingest (final:309)
    c = dist_spgemm(a, a, mesh)            # the full C on every rank

or, memory-scalable, each rank reading only its own rows::

    bounds = partition_rows(np.ones(n), mesh.size)
    lo, hi = multihost.process_row_range(bounds, mesh)
    a_local = read_pattern(path, row_range=(lo, hi))
    c = multihost.dist_spgemm_from_local(a_local, bounds, b, mesh)
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import RowMesh, make_row_mesh

__all__ = [
    "barrier",
    "dist_spgemm_from_local",
    "global_row_mesh",
    "initialize",
    "process_row_range",
]


def initialize(backend: str = "nccl", **kwargs) -> None:
    """``torch.distributed.init_process_group(backend, **kwargs)``; by
    default ``init_method="env://"`` (``MASTER_ADDR``/``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE``, as ``torchrun`` sets them), else pass
    ``init_method``, ``world_size`` and ``rank`` (≡ what mpirun
    distributes).  NCCL takes one rank a card; ranks sharing a card, or
    ranks on the CPU, need ``backend="gloo"``.  Does nothing when the group
    is already up."""
    if not dist.is_initialized():
        dist.init_process_group(backend, **kwargs)


def global_row_mesh(device: str | torch.device = "cuda") -> RowMesh:
    """This rank's mesh over every rank of the default group (the
    MPI_COMM_WORLD analogue)."""
    return make_row_mesh(device=device)


def barrier(name: str = "binary-spgemm") -> None:
    """Wait for every rank (≡ MPI_Barrier before timing, final:319); a
    no-op in a process without a group.  ``name`` labels the barrier as
    the JAX package's does; torch's barriers are anonymous."""
    del name
    if dist.is_initialized():
        dist.barrier()


def process_row_range(bounds: np.ndarray, mesh: RowMesh) -> tuple[int, int]:
    """The contiguous row range this rank owns under the global partition
    ``bounds`` (one entry a rank, from :func:`.mesh.partition_rows`), so it
    can read its own rows of a file instead of all of A."""
    return int(bounds[mesh.rank]), int(bounds[mesh.rank + 1])


def dist_spgemm_from_local(a_local, bounds, b, mesh: RowMesh | None = None, *,
                           device: str | torch.device = "cuda"):
    """C = A·B where THIS rank holds only its row slice of A.

    ``a_local`` is the ``(hi - lo, m)`` slice :func:`process_row_range`
    names; ``bounds`` the global partition (identical on every rank); B is
    replicated (the reference's semantics).  The shard padding is agreed
    with one small gather of every rank's nnz and flop counts (≡
    MPI_Allreduce(MAX)); the step and the assembly are
    :func:`.dist_spgemm.dist_spgemm_sharded`'s.  Result: the full C on
    every rank."""
    from ..ops.spgemm import _upload, pad_bucket, pad_chunk_csr, row_flops
    from . import comm
    from .dist_spgemm import _assemble, _bounds_2d, dist_spgemm_sharded

    mesh = mesh if mesh is not None else global_row_mesh(device)
    bounds = np.asarray(bounds, np.int64)
    if len(bounds) != mesh.size + 1:
        raise ValueError(f"bounds has {len(bounds) - 1} shards, the group has "
                         f"{mesh.size} ranks")
    lo, hi = process_row_range(bounds, mesh)
    if a_local.shape[0] != hi - lo:
        raise ValueError(
            f"a_local has {a_local.shape[0]} rows, this rank owns [{lo}, {hi})"
        )
    n, m = int(bounds[-1]), b.n_cols
    rows_pad = pad_bucket(int(np.max(np.diff(bounds))) or 1, minimum=1)
    local = torch.tensor([a_local.nnz, int(row_flops(a_local, b).sum())],
                         dtype=torch.int64)
    agreed = comm.all_gather(local, mesh).max(0).values
    nnz_pad = pad_bucket(int(agreed[0]) or 1, minimum=1)
    flops_pad = pad_bucket(int(agreed[1]) or 8)
    ptr, idx, nnz_local = pad_chunk_csr(a_local, 0, hi - lo, rows_pad, nnz_pad)
    step = dist_spgemm_sharded(
        _upload(ptr, mesh.device), _upload(idx, mesh.device), nnz_local,
        _upload(np.asarray(b.indptr, np.int32), mesh.device),
        _upload(np.asarray(b.indices, np.int32), mesh.device),
        mesh=mesh, n_cols=m, flops_pad=flops_pad)
    return _assemble(step, _bounds_2d(bounds), (n, m), mesh)
