"""Start a local process group and run one function on each of its ranks.

    from binary_spgemm_tpu_torch.parallel.launch import launch
    results = launch(fn, 4, a, b, timeout=120)                # on the card
    results = launch(fn, 4, a, b, device="cpu", timeout=120)  # on the host

``fn(mesh, *args)`` must be a module-level function (ranks start by
``spawn`` and import it).  Each rank joins the group at
``tcp://localhost:<free port>`` over :func:`default_backend`'s choice,
builds its :class:`.mesh.RowMesh` on ``device`` and calls ``fn``; the
parent returns each rank's result in rank order.  If a rank raises, dies
or the group outlives ``timeout`` seconds, every rank is killed and the
parent raises with the rank's traceback: a failure is never swallowed.

NCCL refuses two ranks on one card, so several ranks sharing a card run
over gloo (its collectives then stage through the host, :mod:`.comm`);
NCCL takes one rank a card.  ``device`` defaults to ``"cuda"`` and raises
where there is no card: the CPU runs only when the caller asks for it.  On
a card the kernels are built once in the parent before the ranks start,
so the ranks load them instead of building.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops.spgemm import resolve_device
from .mesh import make_row_mesh

__all__ = ["default_backend", "launch", "torchrun_backend"]


def default_backend(n_ranks: int, device: str | torch.device) -> str:
    """NCCL where every rank of the machine has a card of its own, else
    gloo (ranks on the CPU, or sharing a card, which NCCL refuses).
    ``n_ranks`` counts the ranks on this machine."""
    device = torch.device(device)
    if device.type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def torchrun_backend(device: str | torch.device) -> str:
    """:func:`default_backend` for a group ``torchrun`` started: the ranks
    on this machine are its ``LOCAL_WORLD_SIZE`` (else ``WORLD_SIZE``)."""
    local = os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1"))
    return default_backend(int(local), device)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, size: int, port: int, backend: str, device: str,
               timeout: float, inputs, results) -> None:
    try:
        # the ranks on this machine, as torchrun says it: the native host
        # tier divides the cores by it
        os.environ["LOCAL_WORLD_SIZE"] = str(size)
        args = inputs.get(timeout=timeout)
        if device == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", world_size=size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout),
        )
        try:
            out = fn(make_row_mesh(size, device=device), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def launch(fn, n_ranks: int, *args, device: str | torch.device = "cuda",
           timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``n_ranks`` spawned ranks of one group on
    ``device`` (``"cuda"`` gives rank r card r modulo the card count, and
    raises where there is no card), over :func:`default_backend`'s backend;
    return their results in rank order.  Raises ``RuntimeError`` if a rank
    fails and ``TimeoutError`` past ``timeout`` seconds, after killing every
    rank."""
    device = resolve_device(device)
    backend = default_backend(n_ranks, device)
    if device.type == "cuda":
        from .. import _build

        _build.build_all()
    ctx = mp.get_context("spawn")
    # the arguments go through a queue, whose feeder thread writes them while
    # the ranks import: passed to the processes themselves, each start would
    # wait for its rank to import torch before the next rank could start
    inputs, results = ctx.Queue(), ctx.Queue()
    inputs.cancel_join_thread()  # a rank that died never reads its copy
    port = _free_port()
    procs = [
        ctx.Process(target=_rank_main, daemon=True, args=(
            fn, rank, n_ranks, port, backend, str(device), timeout, inputs, results))
        for rank in range(n_ranks)
    ]
    for p in procs:
        p.start()
    for _ in procs:
        inputs.put(args)
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{n_ranks} ranks of {getattr(fn, '__name__', fn)} ran past "
                    f"{timeout} s; ranks {sorted(set(range(n_ranks)) - set(out))} "
                    "had not finished"
                )
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                for rank, p in enumerate(procs):
                    if rank not in out and p.exitcode not in (None, 0):
                        raise RuntimeError(
                            f"rank {rank} died with exit code {p.exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            if p.is_alive() and len(out) < n_ranks:
                p.kill()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[rank] for rank in range(n_ranks)]
