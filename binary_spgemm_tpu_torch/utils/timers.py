"""Benchmark timing helpers (≡ tic/toc + stats, final/utils.c:104-113, :330-333).

The reference reports mean / median / fastest of ``times`` barrier-synced repeats
(final/SpGEMM_mpi_omp.c:318-336).  ``BenchStats`` reproduces that report.  A
caller timing card work on the host clock passes
``barrier=torch.cuda.synchronize`` to :func:`bench_fn`; :func:`event_seconds`
times it on the card's own clock instead.
"""
from __future__ import annotations

import dataclasses
import statistics
import time

__all__ = ["Timer", "BenchStats", "bench_fn", "event_seconds", "graph_seconds"]


class Timer:
    """Monotonic region timer (≡ tic/toc macros, final/utils.h:7-8)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False


@dataclasses.dataclass
class BenchStats:
    times: list[float]

    @property
    def mean(self) -> float:
        return statistics.fmean(self.times)

    @property
    def median(self) -> float:
        return statistics.median(self.times)

    @property
    def fastest(self) -> float:
        return min(self.times)


def bench_fn(fn, *, repeats: int, barrier=None) -> BenchStats:
    """Time ``fn()`` ``repeats`` times; ``barrier`` (if given) syncs before each run."""
    times = []
    for _ in range(repeats):
        if barrier is not None:
            barrier()
        with Timer() as t:
            fn()
        times.append(t.seconds)
    return BenchStats(times)


def event_seconds(fn, *, reps: int = 1, repeats: int = 5) -> BenchStats:
    """Card time of ``fn()`` from CUDA events on the current stream: each of
    ``repeats`` samples is the mean over ``reps`` back-to-back calls, between
    two events, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / reps)
    return BenchStats(times)


def graph_seconds(fn, *, repeats: int = 5) -> BenchStats:
    """Card time of ``fn()`` without the host's launches: ``fn`` captured
    once in a CUDA graph (after one warm-up call), each of ``repeats``
    samples one replay between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return event_seconds(graph.replay, repeats=repeats)
