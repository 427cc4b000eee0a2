"""The row partition and each rank's view of its process group.

Counterpart of ``binary_spgemm_tpu/parallel/mesh.py``.  The JAX package's
1-D device mesh over the ``"rows"`` axis becomes a ``torch.distributed``
process group with one rank per shard; a :class:`RowMesh` is one rank's
handle on it: the group, its rank and size, and the torch device its shard
computes on.  The row partition is the JAX package's, verbatim.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops.spgemm import resolve_device

__all__ = ["ROWS_AXIS", "RowMesh", "make_row_mesh", "partition_rows"]

ROWS_AXIS = "rows"


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """One rank's handle on the row-partition group: shard ``rank`` of
    ``size``, computing on ``device``.  ``group`` is ``None`` in a process
    that runs alone without a process group (one shard, no collective)."""

    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str | None:
        """The group's backend (``"nccl"`` or ``"gloo"``), ``None`` alone."""
        return None if self.group is None else dist.get_backend(self.group)


def make_row_mesh(n_ranks: int | None = None, *,
                  device: str | torch.device = "cuda") -> RowMesh:
    """This rank's :class:`RowMesh` over the default process group.
    ``n_ranks``, when given, must equal the group's size.

    ``device="cuda"`` without an index takes card ``LOCAL_RANK`` (else the
    rank) modulo the card count, so one rank a card under NCCL and every
    rank on the one card of a one-card machine; a card device is made the
    process's current one, as NCCL wants.  Without a process group the mesh
    is this process alone (``n_ranks`` 1 or ``None``)."""
    if dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    elif n_ranks in (None, 1):
        group, rank, size = None, 0, 1
    else:
        raise RuntimeError(
            f"{n_ranks} ranks asked for, but no process group is initialised: "
            "start the ranks with parallel.launch.launch or torchrun"
        )
    if n_ranks is not None and n_ranks != size:
        raise ValueError(f"n_ranks {n_ranks} != the group's size {size}")
    device = torch.device(device)
    if device.type == "cuda":
        resolve_device(device)  # raises where there is no card
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return RowMesh(group, rank, size, device)


def partition_rows(
    row_weights: np.ndarray, n_shards: int, *, balance: str = "flops"
) -> np.ndarray:
    """Contiguous row partition boundaries (length ``n_shards + 1``).

    ``balance="rows"`` reproduces the reference's equal-rows split
    (``tasksize = An / numtasks``, final/SpGEMM_mpi_omp.c:165) generalised to
    non-divisible sizes.  ``balance="flops"`` splits at equal cumulative-weight
    quantiles — fixing the reference's known load imbalance on skewed matrices
    (its ``schedule(dynamic)`` experiment, old/SpGEMM_omp.c:264).
    """
    n = len(row_weights)
    if balance == "rows":
        bounds = np.linspace(0, n, n_shards + 1)
        return np.round(bounds).astype(np.int64)
    if balance != "flops":
        raise ValueError(f"unknown balance mode {balance!r}")
    cum = np.cumsum(np.asarray(row_weights, dtype=np.int64))
    total = cum[-1] if n else 0
    if total == 0:
        return np.round(np.linspace(0, n, n_shards + 1)).astype(np.int64)
    targets = total * np.arange(1, n_shards, dtype=np.float64) / n_shards
    # boundary after the row that crosses each quantile target
    cuts = np.minimum(np.searchsorted(cum, targets, side="left") + 1, n)
    bounds = np.concatenate([[0], cuts, [n]])
    return np.maximum.accumulate(bounds).astype(np.int64)
