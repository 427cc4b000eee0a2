"""Run one cell of the benchmark once and print its result line.

    python3 -m spgemm_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this package and
the program (``binary_spgemm_tpu_torch``) on a machine with the cards the
cell asks for.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and the compared numbers under
``checks``, last); the compared numbers with their limits are also the last
lines of standard error.  Exits with another code than 0, and prints no
result, without the cards the cell asks for, or where JAX or the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from spgemm_bench.spec import ROOT  # noqa: E402


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program builds its own kernels under its package's ``build/``)."""
    base = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()

    import torch

    from spgemm_bench.harness import forbidden_modules, run_cell
    from spgemm_bench.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t_start=T_START)
    found = sorted(set(result.pop("forbidden")) | set(forbidden_modules()))
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
