"""P2 on the card: the bitonic network that skips the merges presorted runs satisfy.

The JAX package's prototype (``benchmarks/ab_wruns.py``) measured the best
case of a shortcut: if a stream arrives as w-aligned sorted runs whose
direction alternates (ascending where ``(start & w) == 0``), the network may
start at merge ``2w`` and skip its first ``log2(w)`` merges — at w = 16 and
L = 4096, 10 of 78 stages.  The same input here (k, L, w = 32768, 4096, 16,
seed 17), through ``ops/bitonic.py::bitonic_network_rows``:

  full      — ``min_kk = 2`` on the random rows (P1's network)
  skip-w16  — ``min_kk = 32`` on the same rows with every w-block presorted

Both run K1's register kernel (L = 4096), where the skipped merges are its
register and warp-shuffle steps.  Each is timed from CUDA events over
back-to-back launches, best of ``TIMES``, and must equal ``torch.sort`` of
the random rows; the verdict row gives this card's saving.

Run: python -m binary_spgemm_tpu_torch.benchmarks.ab_wruns
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.bitonic import _stages, bitonic_network_rows
from ..utils.timers import event_seconds
from ..utils.trace import measure_dispatch_floor
from ._provenance import emit, require_card

K, L, W, SEED = 32768, 4096, 16, 17
REPS = 5  # launches per timed sample
TIMES = 5  # timed samples; the best is kept


def alternating_runs(x: torch.Tensor, w: int) -> torch.Tensor:
    """Each w-aligned block of each row of ``x`` sorted, descending where
    ``(start & w) != 0``: the invariant the network's merges up to size w
    establish."""
    k, n = x.shape
    xb = torch.sort(x.reshape(k, n // w, w), dim=2).values
    desc = (torch.arange(n // w, device=x.device) * w & w) != 0
    xb[:, desc] = xb[:, desc].flip(2)
    return xb.reshape(k, n)


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=None, help="rows file (default results.jsonl)")
    args = ap.parse_args(argv)

    dev = require_card()
    floor = measure_dispatch_floor(device=dev)
    x_host = np.random.default_rng(SEED).integers(0, 1 << 30, (K, L), dtype=np.int32)
    x = torch.from_numpy(x_host).to(dev)
    xp = alternating_runs(x, W)
    want = torch.sort(x, dim=1).values
    stages = _stages(L)
    skipped = sum(kk < 2 * W for kk, _ in stages)
    rows, t = [], {}
    for name, min_kk, inp in (("full", 2, x), ("skip-w16", 2 * W, xp)):
        f = lambda: bitonic_network_rows(inp, min_kk)  # noqa: E731
        exact = torch.equal(f(), want)
        t[name] = event_seconds(f, reps=REPS, repeats=TIMES).fastest
        rows.append(emit({
            "ab": "wruns", "variant": name, "k": K, "L": L, "w": W,
            "min_kk": min_kk, "stages": sum(kk >= min_kk for kk, _ in stages),
            "t": t[name], "floor_s": floor, "bit_exact": exact,
        }, args.results))
        if not exact:
            raise AssertionError(f"{name} differs from torch.sort")
    save = 1 - t["skip-w16"] / t["full"]
    rows.append(emit({
        "ab": "wruns", "variant": "verdict", "bit_exact": "n/a",
        "t": 0.0,
        "pass_skip_saving_pct": save * 100,
        "passes_skipped": f"{skipped} of {len(stages)}",
        "note": (
            f"skip-w16 takes {t['skip-w16'] * 1e3:.4f} ms against full's "
            f"{t['full'] * 1e3:.4f} ms on this card (CUDA events): skipping "
            f"{skipped} of {len(stages)} stages, all register and warp-shuffle "
            f"steps of K1's register kernel, saves {save * 100:.1f}% of one "
            f"sort; it needs pow2-aligned runs of alternating direction"
        ),
    }, args.results))
    return rows


if __name__ == "__main__":
    main()
