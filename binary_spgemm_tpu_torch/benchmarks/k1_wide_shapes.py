"""K1's wide kernel at each block shape it is built at, on the card.

``csrc/bitonic.cu`` builds the wide kernel (``sort_rows_wide_kernel``, K1
for 4097 <= L <= 32768) at two block shapes (threads x slots a thread) for
each padded length, :data:`LOG_N`; ``ops/bitonic.py::wide_block`` picks one
by L from these times.  At each length the driver times

  wide TxN    — the wide kernel with T threads holding N slots each
  smem        — K1's shared-memory kernel (``_sort_rows_variant(x, "smem")``)
  torch.sort  — ``torch.sort(x, dim=1)``

in turns (forward, then back), each from CUDA events over back-to-back
launches, best of ``--times``, on int32 rows from a seeded generator on the
card.  A row is bit-exact when it equals ``torch.sort``.  Run it again when
the wide kernel changes, and move ``wide_block``'s choice to the winners.

Usage:
  python -m binary_spgemm_tpu_torch.benchmarks.k1_wide_shapes [--results PATH]
"""
from __future__ import annotations

import argparse

import torch

from ..ops import bitonic
from ..utils.timers import event_seconds
from ._provenance import emit, require_card

# (k, L): the op family's and the counting family's bench rows, the closure's
# host-route rows, and full rows at three k (the waves)
SHAPES = [(1024, 4352), (1024, 4608), (1024, 4864), (512, 6912), (512, 7232),
          (512, 7552), (2048, 8096), (512, 8192), (1024, 8192), (2048, 8192),
          (256, 16384), (256, 17408), (128, 32768)]
# log2 P -> log2 of the slots a thread holds, the K1 block shapes built
# (csrc/bitonic.cu::launch_wide; tests/test_torch_bitonic.py holds the two equal)
LOG_N = {13: (4, 5), 14: (4, 5), 15: (5, 6)}
REPS = 10  # launches per timed sample


def wide_shape(x: torch.Tensor, log_n: int) -> torch.Tensor:
    """K1's wide kernel on ``x`` at the block shape of 2^log_n slots a thread,
    not counted in ``bitonic_sort_rows.launches``."""
    return bitonic._launch("bitonic_sort_rows_wide", x, log_n)


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--times", type=int, default=3)
    ap.add_argument("--results", default=None, help="rows file (default results.jsonl)")
    args = ap.parse_args(argv)
    dev = require_card()
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for k, L in SHAPES:
        x = torch.randint(-(1 << 31), (1 << 31) - 1, (k, L), dtype=torch.int32,
                          device=dev, generator=gen)
        want = torch.sort(x, dim=1).values
        log_p = (L - 1).bit_length()
        fns = {f"wide {(1 << log_p) >> n}x{1 << n}": lambda n=n: wide_shape(x, n)
               for n in LOG_N[log_p]}
        fns["smem"] = lambda: bitonic._sort_rows_variant(x, "smem")
        fns["torch.sort"] = lambda: torch.sort(x, dim=1).values
        exact = {name: bool(torch.equal(f(), want)) for name, f in fns.items()}
        best: dict[str, float] = {}
        order = list(fns.items())
        for name, f in order + order[::-1]:
            t = event_seconds(f, reps=REPS, repeats=args.times).fastest
            best[name] = min(best.get(name, t), t)
        kept = "wide {}x{}".format(*bitonic.wide_block(L))
        for name in fns:
            rows.append(emit({
                "ab": "k1-wide-shapes", "variant": name, "k": k, "L": L, "t": best[name],
                "kept": name == kept, "bit_exact": exact[name]}, args.results))
            print(f"[{k}, {L}] {name}: {best[name] * 1e3:.4f} ms, bit-exact {exact[name]}")
        if not all(exact.values()):
            raise AssertionError(f"a kernel differs from torch.sort at [{k}, {L}]: {exact}")
        del x, want
    return rows


if __name__ == "__main__":
    main()
