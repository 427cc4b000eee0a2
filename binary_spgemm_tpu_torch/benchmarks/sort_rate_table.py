"""Calibrate the port's sort-rate tables (``utils/trace.py``) by measurement.

The counterpart of the JAX package's ``benchmarks/sort_rate_table.py``.  It
measures the BEST available full-sort rate on the card at every production
row length, and appends one row per (kernel, L) to ``micro.jsonl`` plus a
summary ``sort_rate_table`` row whose ``table_2d_ns`` / ``table_flat_ns`` are
what ``utils/trace.py``'s ``SORT_RATE_2D_NS`` / ``SORT_RATE_FLAT_NS`` pin for
this card.

* 2-D row sorts at L = 256 ... 8192, ``k = E / L`` rows, so every shape holds
  the same E elements: ``torch.sort(x, dim=1, stable=False)`` and K1
  (``bitonic_sort_rows``, which takes every L up to 32,768), the faster one
  kept.
* Flat sorts at L = 2^19 ... 2^25: a chain of ``R = E / L`` sorts
  ``s = torch.sort(s ^ i)`` captured in one CUDA graph and replayed between
  two CUDA events, so the host's launches do not count (the xor re-perturbs
  each round; a radix sort's work does not depend on the data), rate = time
  / (R·L).

Every time is from CUDA events, so no launch floor is subtracted; the floor
measured in-run is recorded beside (``floor_s``).  Data is made on the card
from a seeded generator.

Usage: python -m binary_spgemm_tpu_torch.benchmarks.sort_rate_table [--elems 27] [--times 5]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.bitonic import bitonic_sort_rows
from ..utils.timers import event_seconds, graph_seconds
from ..utils.trace import measure_dispatch_floor
from ._provenance import MICRO, emit, require_card

LENGTHS_2D = (256, 512, 1024, 2048, 4096, 8192)
LOG_LENGTHS_FLAT = (19, 20, 22, 23, 25)


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--elems", type=int, default=27, help="log2 total elements per shape")
    ap.add_argument("--times", type=int, default=5)
    ap.add_argument("--only", choices=("all", "2d", "flat"), default="all")
    ap.add_argument("--results", default=MICRO, help="rows file (default micro.jsonl)")
    args = ap.parse_args(argv)

    dev = require_card()
    floor = measure_dispatch_floor(device=dev)
    print(f"# in-run launch floor: {floor * 1e3:.4f} ms", flush=True)
    gen = torch.Generator(device=dev).manual_seed(11)
    E = 1 << args.elems
    rows = []
    table_2d: dict[int, float] = {}
    for L in LENGTHS_2D if args.only != "flat" else ():
        k = E // L
        x = torch.randint(0, 1 << 30, (k, L), dtype=torch.int32, device=dev,
                          generator=gen)
        want = torch.sort(x, dim=1, stable=False).values
        sample = torch.arange(0, k, max(k // 64, 1), device=dev)
        ref_ok = np.array_equal(want[sample].cpu().numpy(),
                                np.sort(x[sample].cpu().numpy(), axis=1))
        best_rate, best_kernel = float("inf"), None
        for name, f in (("torch.sort", lambda: torch.sort(x, dim=1, stable=False)),
                        ("k1", lambda: bitonic_sort_rows(x))):
            out = f()
            exact = ref_ok if name == "torch.sort" else torch.equal(out, want)
            del out
            t = event_seconds(f, repeats=args.times).fastest
            rate = t * 1e9 / (k * L)
            rows.append(emit({
                "bench": "sort_rate_table", "kind": "2d", "kernel": name,
                "k": k, "L": L, "fastest_s": t, "floor_s": floor,
                "ns_per_elem": rate, "bit_exact": bool(exact),
            }, args.results))
            if not exact:
                raise AssertionError(f"{name} differs at [{k}, {L}]")
            if rate < best_rate:
                best_rate, best_kernel = rate, name
        table_2d[L] = best_rate
        print(f"# L={L}: best {best_kernel}", flush=True)
        del x, want

    table_flat: dict[int, float] = {}
    for logL in LOG_LENGTHS_FLAT if args.only != "2d" else ():
        L = 1 << logL
        R = max(E // L, 1)
        x = torch.randint(0, 1 << 30, (L,), dtype=torch.int32, device=dev,
                          generator=gen)

        def chain(x=x, R=R):
            s = x
            for i in range(R):
                s = torch.sort(s ^ i, stable=False).values
            return s

        out = chain()
        # the chain's last round sorted (prev ^ (R-1)): gate that the output
        # IS ascending (torch.sort's bit-exactness is pinned by the 2-D rows)
        exact = bool((out[1:] >= out[:-1]).all())
        t = graph_seconds(chain, repeats=args.times).fastest
        rate = t * 1e9 / (R * L)
        rows.append(emit({
            "bench": "sort_rate_table", "kind": "flat", "kernel": "torch.sort",
            "L": L, "chain": R, "fastest_s": t, "floor_s": floor,
            "ns_per_elem": rate, "bit_exact": exact,
        }, args.results))
        if not exact:
            raise AssertionError(f"flat chain at L={L} is not ascending")
        table_flat[L] = rate
        del x, out

    rows.append(emit({
        "bench": "sort_rate_table", "kind": "summary",
        "platform": torch.cuda.get_device_name(dev),
        "floor_s": floor,
        "elems_per_shape": E,
        "table_2d_ns": table_2d,
        "table_flat_ns": table_flat,
        "bit_exact": True,
    }, args.results))
    return rows


if __name__ == "__main__":
    main()
