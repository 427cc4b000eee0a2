"""The closure's host route on K1's wide and shared-memory kernels, on the card.

``graph.transitive_closure`` of ``BCSR.random(65536, 65536, 1.0, seed=7)``
(``chip_smoke.py``'s closure input: 8 rounds, 1,866,786 nnz) on the host
route, in one process, in turns (ABBA, ``--pairs`` times each way):

  wide  — K1 as routed: its wide kernel on rounds 2-4's rows of 4608, 4864
          and 17,408 slots
  smem  — the same plans with K1 routed to its shared-memory kernel at every
          length past the register window, as before the wide kernel

Each run reports its wall (host clock, call to a synchronize), the wall of
each round's ``spgemm_or`` (a host product: plan, staging, the device run,
the pull and assembly), the host seconds spent in K1's wrapper (launch path
included) and K1's device time (CUDA events around each launch).  A gap
between the two routes that lies in the rounds K1 runs on, and in K1's own
host or device time, is K1's; a gap elsewhere is the host's.  Every run's
closure must equal the first's and have the input's closure nnz.

Usage:
  python -m binary_spgemm_tpu_torch.benchmarks.closure_k1 [--pairs N] [--results PATH]
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import BCSR
from ..ops import bitonic, ell, graph
from ._provenance import emit, require_card

INPUT, CLOSURE_NNZ = (65536, 1.0, 7), 1_866_786  # BCSR.random(n, n, d, seed)


def run_once(m: BCSR, route: str) -> tuple[BCSR, dict]:
    """One host-route closure with K1 routed as ``route`` says; returns the
    closure and its times."""
    k1_variant, sort_variant, step = bitonic.k1_variant, bitonic._sort_rows_variant, graph.spgemm_or
    k1 = {"host_s": 0.0, "events": [], "by_variant": {}}
    rounds = []

    def routed(L):
        v = k1_variant(L)
        return "smem" if route == "smem" and v == "wide" else v

    def timed_sort(x, variant):
        t0 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = sort_variant(x, variant)
        end.record()
        k1["events"].append((start, end))
        k1["host_s"] += time.perf_counter() - t0
        k1["by_variant"][variant] = k1["by_variant"].get(variant, 0) + 1
        return out

    def timed_step(*args, **kwargs):
        t0 = time.perf_counter()
        out = step(*args, **kwargs)
        rounds.append(time.perf_counter() - t0)
        return out

    ell._EXEC_CACHE.clear()
    bitonic.k1_variant, bitonic._sort_rows_variant, graph.spgemm_or = routed, timed_sort, timed_step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = graph.transitive_closure(m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        bitonic.k1_variant, bitonic._sort_rows_variant, graph.spgemm_or = (
            k1_variant, sort_variant, step)
    k1_ms = sum(s.elapsed_time(e) for s, e in k1["events"])
    return got, {"wall_s": wall, "round_s": rounds, "k1_host_s": k1["host_s"],
                 "k1_device_ms": k1_ms, "k1_by_variant": k1["by_variant"]}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--results", default=None, help="rows file (default results.jsonl)")
    args = ap.parse_args(argv)
    require_card()
    n, d, seed = INPUT
    m = BCSR.random(n, n, d, seed=seed)
    first, _ = run_once(m, "wide")  # warm-up: builds, plans, the allocator's pools
    if first.nnz != CLOSURE_NNZ:
        raise AssertionError(f"closure nnz {first.nnz}, expected {CLOSURE_NNZ}")
    rows = []
    order = ["wide", "smem", "smem", "wide"] * args.pairs
    for i, route in enumerate(order):
        got, rec = run_once(m, route)
        rows.append(emit({"ab": "closure-k1", "route": route, "run": i, **rec,
                          "bit_exact": got.equals(first)}, args.results))
        print(f"run {i} {route}: wall {rec['wall_s']:.4f} s, rounds "
              f"{[round(s, 4) for s in rec['round_s']]}, K1 host {rec['k1_host_s'] * 1e3:.3f} ms, "
              f"K1 device {rec['k1_device_ms']:.4f} ms, {rec['k1_by_variant']}")
        if not rows[-1]["bit_exact"]:
            raise AssertionError(f"run {i} ({route}) differs from the first closure")
    for route in ("wide", "smem"):
        walls = sorted(r["wall_s"] for r in rows if r["route"] == route)
        print(f"{route}: wall min {walls[0]:.4f}, median {walls[len(walls) // 2]:.4f}, "
              f"max {walls[-1]:.4f} s over {len(walls)} runs")
    return rows


if __name__ == "__main__":
    main()
