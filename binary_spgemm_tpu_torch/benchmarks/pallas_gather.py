"""P3/P4 on the card: the class-table row gathers against torch.index_select.

The JAX package's prototype (``benchmarks/pallas_gather.py``) measured a
VMEM-resident table gather, and the gather fused with the key pack, against
XLA's gather at a headline-class shape: a 2^16-row table of width 16 and 2^20
positions (16.8 M output slots), row ids below 8192, key shift 17.  The same
shape here, made from numpy's generator with seed 0 as there:

  xla        — ``torch.index_select(table, 0, pos)`` (the ``"xla"`` row)
  pallas     — P3 ``class_gather`` (one group of 2^20 positions)
  pallas-key — P4 ``class_gather_keys``, ``(row << 17) | col``

through the kernels' own signatures (``ops/gather.py``: the positions and
row ids one ``[1, e]`` group, ``rows_pad`` 8192, ``n_cols`` 2^16, so no slot
is a sentinel).  Each is timed from CUDA events over back-to-back launches,
best of ``TIMES``, and held equal to the ``index_select`` result.

Run: python -m binary_spgemm_tpu_torch.benchmarks.pallas_gather
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.gather import class_gather, class_gather_keys
from ..utils.timers import event_seconds
from ._provenance import emit, require_card

T, W, E, ROWS_PAD, SHIFT = 1 << 16, 16, 1 << 20, 8192, 17
REPS = 20  # launches per timed sample
TIMES = 5  # timed samples; the best is kept


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=None, help="rows file (default results.jsonl)")
    args = ap.parse_args(argv)

    dev = require_card()
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.integers(0, T, (T, W), dtype=np.int32)).to(dev)
    pos = torch.from_numpy(rng.integers(0, T, (E,), dtype=np.int32)).to(dev)
    rows_id = torch.from_numpy(rng.integers(0, ROWS_PAD, (E,), dtype=np.int32)).to(dev)
    slots = E * W
    pos2, rows2 = pos[None], rows_id[None]

    def timed(f) -> float:
        return event_seconds(f, reps=REPS, repeats=TIMES).fastest

    def xla():
        return torch.index_select(table, 0, pos)

    ref = xla()
    t_x = timed(xla)
    out = [emit({"ab": "pallas-gather", "variant": "xla", "t": t_x,
                 "ns_per_slot": t_x / slots * 1e9, "w": W, "E": E,
                 "bit_exact": "n/a"}, args.results)]  # the reference itself
    want_cols = ref.reshape(1, slots)
    want_rows = rows2.repeat_interleave(W, dim=1)
    want_keys = (want_rows << SHIFT) | want_cols
    for name, f, ok in (
        ("pallas", lambda: class_gather(table, pos2, rows2, ROWS_PAD, T),
         lambda got: torch.equal(got[0], want_rows) and torch.equal(got[1], want_cols)),
        ("pallas-key",
         lambda: class_gather_keys(table, pos2, rows2, ROWS_PAD, T, SHIFT),
         lambda got: torch.equal(got, want_keys)),
    ):
        exact = bool(ok(f()))
        t = timed(f)
        out.append(emit({"ab": "pallas-gather", "variant": name, "t": t,
                         "ns_per_slot": t / slots * 1e9, "w": W, "E": E,
                         "bit_exact": exact, "speedup_vs_xla": t_x / t},
                        args.results))
        if not exact:
            raise AssertionError(f"{name} differs from torch.index_select")
    return out


if __name__ == "__main__":
    main()
