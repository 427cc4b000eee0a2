"""P1 on the card: the full bitonic network over rows against torch.sort and K1.

The JAX package's prototype (``benchmarks/pallas_sort.py``) measured a
VMEM-resident bitonic network against XLA's sort.  Here the network is
``ops/bitonic.py::bitonic_network_rows(x, 2)`` (K1's kernels, chosen by the
row length), timed beside

  torch.sort  — ``torch.sort(x, dim=1)`` (the counterpart of the ``"xla"`` row)
  network     — ``bitonic_network_rows(x, 2)``, P1
  k1          — K1 ``bitonic_sort_rows(x)``, the same network with rows of any length

at the prototype's shapes, each from CUDA events over back-to-back launches,
best of ``--times``.  Rows are int32 from a seeded generator on the card.  A
kernel's row is bit-exact when it equals ``torch.sort``; torch.sort's own row
when 64 sampled rows equal ``np.sort``.

Usage:
  python -m binary_spgemm_tpu_torch.benchmarks.pallas_sort --check  # plain version, CPU
  python -m binary_spgemm_tpu_torch.benchmarks.pallas_sort          # card A/B, results.jsonl
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops import bitonic
from ..utils.timers import event_seconds
from ._provenance import emit, require_card

SHAPES = [(8192, 2048), (65536, 2048), (16384, 8192)]
CHECK_SHAPES = [(16, 256), (8, 1024)]
REPS = 5  # launches per timed sample


def check() -> None:
    """The plain version and the CPU wrapper against ``np.sort`` at the JAX
    script's check shapes."""
    rng = np.random.default_rng(0)
    for k, L in CHECK_SHAPES:
        x = rng.integers(0, 1 << 30, (k, L), dtype=np.int32)
        want = np.sort(x, axis=1)
        xt = torch.from_numpy(x)
        for f in (bitonic.bitonic_network_rows_plain, bitonic.bitonic_network_rows):
            got = f(xt, 2).numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"{f.__name__} differs from np.sort at [{k}, {L}]")
        print(f"plain ok [{k}, {L}]")


def sorted_sample_ok(x: torch.Tensor, s: torch.Tensor, n: int = 64) -> bool:
    """``s`` equals ``np.sort`` of ``x`` on ``n`` rows spread over ``x``."""
    rows = torch.linspace(0, x.shape[0] - 1, n, device=x.device).long().unique()
    return np.array_equal(s[rows].cpu().numpy(), np.sort(x[rows].cpu().numpy(), axis=1))


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--times", type=int, default=5)
    ap.add_argument("--results", default=None, help="rows file (default results.jsonl)")
    args = ap.parse_args(argv)
    if args.check:
        check()
        return []

    dev = require_card()
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for k, L in SHAPES:
        x = torch.randint(0, 1 << 30, (k, L), dtype=torch.int32, device=dev,
                          generator=gen)
        want = torch.sort(x, dim=1).values
        variants = [
            ("torch.sort", lambda: torch.sort(x, dim=1).values),
            ("network", lambda: bitonic.bitonic_network_rows(x, 2)),
            ("k1", lambda: bitonic.bitonic_sort_rows(x)),
        ]
        for name, f in variants:
            t0 = time.perf_counter()
            out = f()
            torch.cuda.synchronize()
            compile_s = time.perf_counter() - t0
            exact = (sorted_sample_ok(x, out) if name == "torch.sort"
                     else torch.equal(out, want))
            del out
            best = event_seconds(f, reps=REPS, repeats=args.times).fastest
            rows.append(emit({
                "ab": "pallas-sort", "variant": name, "k": k, "L": L,
                "block": max(1, 4096 // L) if name != "torch.sort" else None,
                "kernel": bitonic.k1_variant(L) if name != "torch.sort" else None,
                "t": best,
                "ns_per_elem": best * 1e9 / (k * L),
                "compile_s": compile_s,
                "bit_exact": bool(exact),
            }, args.results))
            if not exact:
                raise AssertionError(f"{name} differs from torch.sort at [{k}, {L}]")
        del x, want
    return rows


if __name__ == "__main__":
    main()
