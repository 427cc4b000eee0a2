"""The control: the reference put in the program's place with one guarantee
of the configuration broken, judged by the same comparison.  It has to come
out not correct.

    python3 -m spgemm_bench.control --workload <cell> --seeds 11,12,13

Each op gives its own control (``ops/<op>.py``, ``Op.control``): a
product's answer is the reference's C with its duplicates left in (every
candidate kept: the merge the one-sort path defers, skipped); the triangle
count counts each wedge-closing edge once, the boolean product's support,
instead of with its multiplicity.

The benchmark's own runs never run it; ``tests/test_bench_control.py``
runs it at a tiny size on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import compare, gen, ops
from .spec import load_cell


def control(cell, seed: int, device) -> tuple[bool, dict]:
    """``(correct, checks)`` of the control's answer on ``seed``."""
    inputs = gen.generate(cell.config, seed)
    op = ops.load(cell.root, cell.mix["op"])
    return compare.judge(op.control(cell.mix, inputs, torch.device(device)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        correct, checks = control(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": True,
                          "correct": correct, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
