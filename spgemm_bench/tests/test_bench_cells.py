"""Whole runs of every cell at tiny size on the CPU: the harness without its
look for a card.  Each cell comes out correct as it is, and ``correct``
comes out false with each fault the cell can have planted in the timed path
(``faults.py``); a new cell needs new files only."""
import json
import time

import pytest

from spgemm_bench import gen
from spgemm_bench.harness import run_cell
from spgemm_bench.spec import load_cell

from . import faults

CELLS = {
    "sprand-n5m-d5.square": [faults.product_answer_altered, faults.product_half_left_out],
    "sprand-n5m-d5.square-esc": [faults.product_answer_altered,
                                 faults.product_half_left_out],
    "g500-s15-ef16.triangles": [faults.triangles_answer_altered,
                                faults.triangles_half_left_out],
    "g500-s15-ef16.square-4card": [faults.dist_answer_altered, faults.dist_half_left_out,
                                   faults.dist_exchange_left_out],
}
CASES = [(cell, None) for cell in CELLS] + [
    (cell, fault) for cell, fs in CELLS.items() for fault in fs]


def _run(root, workload, *, trace=False, patch=None, seed=2**31 + 17):
    cell = load_cell(workload, root)
    try:
        return run_cell(cell, seed=seed, seconds=0.3, trace=trace,
                        t_start=time.perf_counter(), device="cpu", patch=patch)
    finally:
        faults.undo()


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{c}-{f.__name__ if f else 'sound'}" for c, f in CASES])
def test_cell_is_judged(tiny_root, workload, fault):
    if fault is None and workload.endswith("4card"):
        # the traced path once, on the cell with the most ranks
        r = _run(tiny_root, workload, trace=True)
        assert set(r["metrics"]) >= {"plan_s", "enqueue_ms", "comm_mb_per_step"}
        assert r["device"]["count"] == 4 and "breakdown" in r
    r = _run(tiny_root, workload, patch=fault)
    assert r["correct"] is (fault is None), r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] >= 1
    assert all(c["limit"] == 0 for c in r["checks"].values())
    if fault is None:
        assert set(r["metrics"]) == {"flop_rate", "call_p95_ms", "setup_s"}


NEW_OP = """
from spgemm_bench import compare, gen, reference
from spgemm_bench.ops import Op as _Base
from spgemm_bench.ops import program_matrix


def _nnz(inputs, device, dedup=True):
    blocks = reference.product_blocks(*inputs, device, dedup=dedup)
    return sum(int(k.numel()) for _, _, k in blocks)


class Op(_Base):
    keep_every = True

    def __init__(self, mix, inputs, device, mesh=None):
        self.device = device
        self.a = self._timed(lambda: program_matrix(inputs))
        self.flops = gen.flops(*inputs[:2])

    def call(self):
        import binary_spgemm_tpu_torch as bt

        return bt.spgemm(self.a, self.a, device=self.device)

    def answer(self, c):
        return len(c.indices)

    def check(self, answers, inputs, device):
        return compare.compare_counts(answers, _nnz(inputs, device)), {}

    @staticmethod
    def control(mix, inputs, device):
        return compare.compare_counts([_nnz(inputs, device, dedup=False)],
                                      _nnz(inputs, device))
"""


def test_new_cell_from_new_files_only(tiny_root):
    """A configuration, a traffic mix, a new kind of call and a per-layer
    metric added as files, and named in BENCHMARK.json, make a cell that
    runs, reports them, is judged, and has a control that fails."""
    from spgemm_bench import control

    b = tiny_root / "spgemm_bench"
    (b / "configs" / "sprand-n2k-d8.json").write_text(
        json.dumps({"generator": "sprand", "structure_seed": 2, "n": 2000, "d": 8}))
    (b / "mixes" / "to-host.json").write_text(
        json.dumps({"op": "square_to_host", "warmup_calls": 1}))
    (b / "ops" / "square_to_host.py").write_text(NEW_OP)
    (b / "metrics" / "flops_per_call.py").write_text(
        "def read(rec):\n    return rec['flops']\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sprand-n2k-d8", "source": "test",
                             "file": "spgemm_bench/configs/sprand-n2k-d8.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "sprand-n2k-d8.to-host",
                               "config": "sprand-n2k-d8", "traffic": "to-host",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "flops_per_call", "unit": "flop", "better": "higher",
                               "source": "host_clock", "layer": "test",
                               "moves": "flop_rate",
                               "workloads": ["sprand-n2k-d8.to-host"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    seed = 2**31 + 17
    r = _run(tiny_root, "sprand-n2k-d8.to-host", trace=True, seed=seed)
    assert r["correct"] is True and set(r["checks"]) == {"count_gap"}
    cell = load_cell("sprand-n2k-d8.to-host", tiny_root)
    want = gen.flops(*gen.generate(cell.config, seed)[:2])
    assert r["metrics"]["flops_per_call"]["value"] == want > 0
    assert "plan_s" in r["metrics"] and "gather_ms" not in r["metrics"]
    assert control.control(cell, seed, "cpu")[0] is False
