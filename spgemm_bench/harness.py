"""Running one cell once: set-up, the closed loop's window, the traced calls
and the check, on one process or on one process a card.

The traffic is one caller in a closed loop: a call, the synchronise that
makes its result usable, the next call, back to back for ``seconds``.  On
several cards every call starts at a barrier of the ranks (over a host-side
gloo group, so that it puts nothing on the device), which also carries the
ranks' agreement to stop.  One call's output, drawn from the seed by
reservoir sampling, is kept for the check (every answer, where an answer is
a number).  Once the window has closed and the peak memory is read, the
``--trace 1`` run profiles a few more calls; then the kept output goes
through the program's own assembly, the program's state is dropped, and
the reference judges the answer.
"""
from __future__ import annotations

import gc
import math
import os
import statistics
import sys
import time
from pathlib import Path

import torch

from . import compare, gen, ops, timeline
from .latency import slowest_rank
from .spec import Cell, load_cell

__all__ = ["FORBIDDEN", "forbidden_modules", "run_cell"]

FORBIDDEN = ("jax", "jaxlib", "flax", "binary_spgemm_tpu")
TRACE_SECONDS = 0.5  # the profiled calls: about this long,
TRACE_CALLS = (3, 40)  # and at least / at most this many
RANK_TIMEOUT_S = 330.0
NAME_CHARS = 160  # an operation's name in the breakdown, cut to this


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (the program's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(op, seconds: float, seed: int, device: torch.device, agree=None) -> dict:
    """The closed loop for ``seconds``; ``agree(x)``, on several ranks, is
    their barrier and returns the largest ``x`` any rank gave."""
    rng = gen.rng_for(seed, 1)
    lat, enq, kept = [], [], []
    start = end = None
    while True:
        done = start is not None and time.perf_counter() - start >= seconds
        if agree is not None:
            done = agree(float(done)) > 0
        if done:
            break
        t0 = time.perf_counter()
        start = t0 if start is None else start
        out = op.call()
        t1 = time.perf_counter()
        _sync(device)
        end = time.perf_counter()
        lat.append(end - t0)
        enq.append(t1 - t0)
        if op.keep_every:
            kept.append(out)
        elif rng.integers(len(lat)) == 0:  # reservoir: each call kept alike
            kept = [out]
        out = None
    return {"start": start, "end": end, "latency_s": lat, "enqueue_s": enq, "kept": kept}


def _trace_calls(median_s: float) -> int:
    lo, hi = TRACE_CALLS
    return min(max(math.ceil(TRACE_SECONDS / max(median_s, 1e-9)), lo), hi)


def _traced(op, calls: int, device: torch.device, agree=None) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            if agree is not None:
                agree(0.0)
            op.call()
            _sync(device)
        wall = time.perf_counter() - t0
    # a user annotation (the profiler's own, such as ``nccl:all_gather``) is
    # a range over device work, not an operation of its own
    events = [(e.device_type == DeviceType.CUDA, e.time_range.start, e.time_range.end,
               e.name) for e in prof.events()
              if not getattr(e, "is_user_annotation", False)]
    return timeline.summarize(events, calls=calls, wall_s=wall)


def _peak(device: torch.device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
         mesh=None, agree=None) -> dict:
    """One process's part of a run (a rank's, with ``mesh``)."""
    stamps = [("start", time.perf_counter())]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    inputs = gen.generate(cell.config, seed)
    stamps.append(("inputs", time.perf_counter()))
    op = ops.make(cell.root, cell.mix, inputs, device, mesh)
    stamps.append(("plan and staging", time.perf_counter()))
    for _ in range(int(cell.mix["warmup_calls"])):
        op.call()
        _sync(device)
    stamps.append(("warm-up", time.perf_counter()))
    print("set-up: " + ", ".join(f"{name} {t1 - t0:.3f} s" for (_, t0), (name, t1)
                                 in zip(stamps, stamps[1:])), file=sys.stderr, flush=True)
    if mesh is not None:
        from binary_spgemm_tpu_torch.parallel import comm

        comm.reset_counters()
    win = _window(op, seconds, seed, device, agree)
    comm_bytes = comm.counters["bytes"] if mesh is not None else None
    peak = _peak(device)
    summary = None
    if trace:
        median = statistics.median(win["latency_s"])
        if agree is not None:  # every rank traces as many calls
            median = agree(median)
        summary = _traced(op, _trace_calls(median), device, agree)
    answers = [op.answer(out) for out in win.pop("kept")]
    op.release()
    _free(device)
    check = None
    if mesh is None or mesh.rank == 0:
        check = op.check(answers, inputs, device)
    return {**win, "peak_bytes": peak, "plan_s": op.plan_s, "trace": summary,
            "comm_bytes": comm_bytes, "check": check, "flops": op.flops,
            "forbidden": forbidden_modules()}


def _rank_main(mesh, root: str, workload: str, seed: int, seconds: float, trace: bool,
               patch=None) -> dict:
    """A rank of a cell on several cards (started by the program's
    ``parallel.launch.launch``)."""
    import torch.distributed as dist

    if patch is not None:
        patch()
    host = dist.new_group(backend="gloo")

    def agree(x: float) -> float:
        t = torch.tensor([x], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host)
        return float(t.item())

    cell = load_cell(workload, Path(root))
    out = _run(cell, seed, seconds, trace, mesh.device, mesh, agree)
    agree(0.0)  # rank 0 checks while the others wait
    return out


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", patch=None) -> dict:
    """Run ``cell`` once; return the result line's object (``checks`` last)."""
    device = torch.device(device)
    if ops.load(cell.root, cell.mix["op"]).distributed:
        from binary_spgemm_tpu_torch.parallel.launch import launch

        os.environ["NCCL_SHM_DISABLE"] = "1"  # nothing written to /dev/shm
        ranks = launch(_rank_main, cell.chips, str(cell.root), cell.name, seed, seconds,
                       trace, patch, device=device, timeout=RANK_TIMEOUT_S)
    else:
        if cell.chips != 1:
            raise ValueError(f"{cell.name}: a single-process op on {cell.chips} chips")
        if patch is not None:
            patch()
        ranks = [_run(cell, seed, seconds, trace, device)]
    first = ranks[0]
    numbers, extra = first["check"]
    correct, checks = compare.judge(numbers)
    rec = {
        "flops": first["flops"],
        "calls": len(first["latency_s"]),
        "window_s": max(r["end"] for r in ranks) - min(r["start"] for r in ranks),
        "latency_s": slowest_rank([r["latency_s"] for r in ranks]),
        "enqueue_s": slowest_rank([r["enqueue_s"] for r in ranks]),
        "setup_s": max(r["start"] for r in ranks) - t_start,
        "plan_s": max(r["plan_s"] for r in ranks),
        "peak_bytes": None if first["peak_bytes"] is None else max(
            r["peak_bytes"] for r in ranks),
        "comm_bytes": None if first["comm_bytes"] is None else sum(
            r["comm_bytes"] for r in ranks),
        "trace": [r["trace"] for r in ranks] if trace else None,
        "chips": cell.chips,
        **extra,
    }
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else device.type,
        "count": cell.chips,
        "memory_peak_bytes": rec["peak_bytes"],
    }
    result = {"correct": correct, "attempted": rec["calls"], "failed": 0,
              "metrics": cell.values(rec, trace), "device": dev}
    if trace:
        summaries = rec["trace"]
        dev["busy_s"] = sum(s["busy_s"] for s in summaries) / len(summaries)
        dev["window_s"] = sum(s["wall_s"] for s in summaries) / len(summaries)
        result["breakdown"] = {
            key: [[name[:NAME_CHARS], sec]
                  for name, sec in timeline.top(_mean_of(s[field] for s in summaries))]
            for key, field in (("device_ops", "by_name"), ("idle_gaps", "gaps"))}
    result["forbidden"] = sorted({m for r in ranks for m in r["forbidden"]})
    result["checks"] = checks
    return result


def _mean_of(dicts) -> dict:
    dicts = list(dicts)
    out: dict[str, float] = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0.0) + v / len(dicts)
    return out
