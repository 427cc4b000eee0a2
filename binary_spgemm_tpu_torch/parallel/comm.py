"""Every collective of the distributed layer.

The JAX package's collectives inside ``shard_map`` map one to one:

==============================  ===========================================
JAX (``parallel/dist_spgemm``)  here
==============================  ===========================================
``lax.all_gather``              :func:`all_gather` into ``[S, ...]``
``lax.psum`` of the nnz         the sum of the gathered per-chunk counts
                                (the same gather gives the offsets)
``lax.psum`` of a count or a    :func:`all_reduce_sum`, one int64
sum (triangles, the closure's   all-reduce (JAX's two int32 limbs, ``(hi
valid count)                    << 15) + lo``, become one int64)
``lax.ppermute`` (cyclic)       :class:`RingShift`: ``batch_isend_irecv`` to
                                rank + 1 and from rank - 1
``lax.axis_index``              ``mesh.rank``
==============================  ===========================================

NCCL moves card tensors and gloo host tensors.  A payload that is not on
its backend's side is copied there explicitly, and the result back to the
input's device; ``counters`` counts the calls, the bytes each rank sends
and the bytes those copies move.  The backend is whatever the caller
initialised: nothing here picks or changes it, and a collective that fails
raises.  A mesh without a process group (one process alone) exchanges
nothing.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import RowMesh

__all__ = ["RingShift", "all_gather", "all_gather_host", "all_reduce_sum", "counters",
           "reset_counters"]

# this process's (this rank's) totals; callers read and reset them around a
# region they measure
counters = {"calls": 0, "bytes": 0, "staged_bytes": 0}


def reset_counters() -> None:
    for key in counters:
        counters[key] = 0


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _backend_device(mesh: RowMesh) -> torch.device:
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    if x.device == device:
        return x
    counters["staged_bytes"] += _nbytes(x)
    return x.to(device)


def _sent(x: torch.Tensor) -> None:
    counters["calls"] += 1
    counters["bytes"] += _nbytes(x)


def all_gather(x: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """Every rank's ``x`` (one shape and dtype on all ranks) stacked in rank
    order, ``[S, *x.shape]``, on ``x``'s device."""
    if mesh.group is None:
        return x.unsqueeze(0).clone()
    src = _to(x.contiguous(), _backend_device(mesh))
    out = torch.empty((mesh.size, *x.shape), dtype=x.dtype, device=src.device)
    _sent(src)
    dist.all_gather(list(out.unbind(0)), src, group=mesh.group)
    return _to(out, x.device)


def all_gather_host(x: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """:func:`all_gather` with the result on the host, through one copy:
    NCCL gathers on the card and the stack comes down; gloo takes ``x``
    down first and gathers on the host."""
    if mesh.backend == "nccl":
        return _to(all_gather(x, mesh), torch.device("cpu"))
    return all_gather(_to(x, torch.device("cpu")), mesh)


def all_reduce_sum(x: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """The element-wise sum of every rank's int64 ``x`` (one shape on all
    ranks), on ``x``'s device: on the card under NCCL, through the host
    under gloo.  A mesh without a group returns ``x``."""
    if x.dtype != torch.int64:
        raise TypeError(f"all_reduce_sum takes int64, got {x.dtype}")
    if mesh.group is None:
        return x
    src = _to(x.contiguous(), _backend_device(mesh))
    out = src.clone() if src is x else src
    _sent(out)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return _to(out, x.device)


class RingShift:
    """One step of the ring: this rank's ``x`` goes to rank + 1 while the
    block of rank - 1 (same shape and dtype) comes in.  The transfer starts
    at construction; :meth:`wait` returns the received block on ``x``'s
    device, so work between the two overlaps the transfer."""

    def __init__(self, x: torch.Tensor, mesh: RowMesh):
        self.device = x.device
        if mesh.group is None or mesh.size == 1:
            self.reqs, self.recv = [], x
            return
        self.send = _to(x.contiguous(), _backend_device(mesh))
        self.recv = torch.empty_like(self.send)
        _sent(self.send)
        self.reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, self.send, (mesh.rank + 1) % mesh.size, mesh.group),
            dist.P2POp(dist.irecv, self.recv, (mesh.rank - 1) % mesh.size, mesh.group),
        ])

    def wait(self) -> torch.Tensor:
        for req in self.reqs:
            req.wait()
        return _to(self.recv, self.device)

