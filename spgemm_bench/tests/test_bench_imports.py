"""Import guard: nothing the benchmark runs imports JAX or the JAX package,
and the yardstick imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "binary_spgemm_tpu"}
PROGRAM = "binary_spgemm_tpu_torch"
# the yardstick: inputs, reference, comparison and metric arithmetic
YARDSTICK = ["gen", "reference", "compare", "roofline", "latency", "timeline", "peaks",
             "classify"]


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (whole names: the
    program's name begins with the JAX package's)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    """The yardstick's files import the standard library, numpy and torch
    only: neither the program nor the harness that drives it."""
    names = _imports(BENCH / f"{name}.py")
    assert PROGRAM not in names
    assert names <= {"__future__", "numpy", "torch", "bisect", "math", "re", "importlib",
                     "pathlib"}


def test_guard_compares_whole_names():
    from spgemm_bench.harness import forbidden_modules

    fake = {"binary_spgemm_tpu_torch": object(), "jaxtyping_like": object()}
    before = dict(sys.modules)
    try:
        sys.modules.update({k: v for k, v in fake.items() if k not in sys.modules})
        assert not set(forbidden_modules()) & {"binary_spgemm_tpu_torch", "jaxtyping_like"}
    finally:
        for k in fake:
            if k not in before:
                sys.modules.pop(k, None)


def test_a_run_loads_no_jax():
    code = ("import spgemm_bench.run, spgemm_bench.harness, spgemm_bench.ops; "
            "import binary_spgemm_tpu_torch, binary_spgemm_tpu_torch.parallel.launch; "
            "from spgemm_bench.harness import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_the_cards(tmp_path):
    """Without a card (or without the program) the command exits non-zero
    and prints no result."""
    import shutil
    import torch

    root = tmp_path
    shutil.copytree(BENCH, root / "spgemm_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root)
    out = subprocess.run([sys.executable, "-m", "spgemm_bench.run", "--workload",
                          "sprand-n5m-d5.square", "--seed", "1", "--seconds", "1"],
                         cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    if not torch.cuda.is_available():
        assert "needs 1 CUDA card" in out.stderr
