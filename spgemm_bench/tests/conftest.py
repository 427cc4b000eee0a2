"""A tiny copy of the benchmark: the committed files with each
configuration cut to a size the CPU runs in a second."""
import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
TINY = {
    "sprand-n5m-d5": {"generator": "sprand", "structure_seed": 1, "n": 3000, "d": 4},
    "g500-s15-ef16": {"generator": "kronecker", "structure_seed": 1, "scale": 9, "edge_factor": 8, "a": 0.57,
                      "b": 0.19, "c": 0.19, "symmetric": True, "self_loops": False},
}


@pytest.fixture
def tiny_root(tmp_path):
    shutil.copytree(BENCH, tmp_path / "spgemm_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        (tmp_path / c["file"]).write_text(json.dumps(TINY[c["name"]]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path
