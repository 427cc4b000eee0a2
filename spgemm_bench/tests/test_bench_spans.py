"""The per-layer metrics that read the program's own spans and counts: each
file on a made-up recorder, and a traced tiny run of each single-process
cell on the CPU reading every one of them that the cell lists."""
import importlib.util
import json
import time
from pathlib import Path

import pytest

from binary_spgemm_tpu_torch.utils import trace
from spgemm_bench.harness import run_cell
from spgemm_bench.spec import load_cell

BENCH = Path(__file__).resolve().parents[1]
SPAN_METRICS = ["plan_search_s", "plan_tables_s", "plan_stage_s", "call_host_ms",
                "input_check_ms", "sync_wait_ms", "syncs_per_call", "sort_slots_per_flop"]
MS = 1_000_000  # nanoseconds


def _read(name, rec):
    spec = importlib.util.spec_from_file_location(f"t_spans_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def S(id, parent, call, name, t0, t1, counts=None):
    return trace.Span(id, parent, call, name, t0 * MS, t1 * MS, counts or {})


# set-up: a plan (search, tables, stage; an inner search nested in a search),
# a staged mask after it; then one untraced-looking stray root and two calls
RECORDER = [
    S(2, 1, 1, "plan.search", 0, 1000),
    S(3, 2, 1, "plan.search", 100, 200),
    S(4, 1, 1, "plan.tables", 1000, 1500),
    S(5, 1, 1, "plan.stage", 1500, 1800),
    S(1, None, 1, "plan", 0, 1900),
    S(6, None, 6, "plan.stage", 2000, 2100),
    S(7, None, 7, "call.run", 2990, 2991, {"sort.slots": 1}),
    S(9, 8, 8, "call.check", 3000, 3002),
    S(10, 8, 8, "sort", 3005, 3010),
    S(11, 8, 8, "sync.sums", 3010, 3015),
    S(8, None, 8, "call.triangle_count", 3000, 3020, {"sort.slots": 600}),
    S(13, 12, 12, "call.check", 3030, 3034),
    S(14, 12, 12, "sync.sums", 3034, 3040),
    S(15, 12, 12, "sync.sums", 3040, 3041),
    S(12, None, 12, "call.triangle_count", 3030, 3050, {"sort.slots": 400}),
]
REC = {"trace": [{"calls": 2}], "flops": 100}


@pytest.fixture
def recorder(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: list(RECORDER))
    monkeypatch.setattr(trace, "dropped", 0)


def test_plan_search_s(recorder):
    assert _read("plan_search_s", REC) == pytest.approx(1.0)  # the outer span only


def test_plan_tables_s(recorder):
    assert _read("plan_tables_s", REC) == pytest.approx(0.5)


def test_plan_stage_s(recorder):
    assert _read("plan_stage_s", REC) == pytest.approx(0.4)  # the plan's and the mask's


def test_call_host_ms(recorder):
    # the last two calls: 20 - 5 and 20 - 7 ms
    assert _read("call_host_ms", REC) == pytest.approx(14.0)


def test_input_check_ms(recorder):
    assert _read("input_check_ms", REC) == pytest.approx(3.0)


def test_sync_wait_ms(recorder):
    assert _read("sync_wait_ms", REC) == pytest.approx(6.0)


def test_syncs_per_call(recorder):
    assert _read("syncs_per_call", REC) == pytest.approx(1.5)


def test_sort_slots_per_flop(recorder):
    assert _read("sort_slots_per_flop", REC) == pytest.approx(5.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_nothing_to_read(monkeypatch, name):
    """No recorder, a dropped span, or no call in the window: no value."""
    monkeypatch.setattr(trace, "spans", lambda: list(RECORDER))
    monkeypatch.setattr(trace, "dropped", 1)
    assert _read(name, REC) is None
    monkeypatch.setattr(trace, "dropped", 0)
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert _read(name, REC) is None
    monkeypatch.delattr(trace, "spans")  # a program without the recorder
    assert _read(name, REC) is None


def test_a_call_without_syncs_or_checks(monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: RECORDER[:7])
    rec = {"trace": [{"calls": 1}], "flops": 4}
    assert _read("syncs_per_call", rec) == 0 and _read("sync_wait_ms", rec) == 0
    assert _read("input_check_ms", rec) is None
    assert _read("call_host_ms", rec) == pytest.approx(1.0)
    assert _read("sort_slots_per_flop", rec) == pytest.approx(0.25)
    assert _read("syncs_per_call", {"trace": [{"calls": 3}]}) is None  # too few calls


def test_every_span_metric_is_listed():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        assert listed[name]["workloads"] and "square-4card" not in str(listed[name])


@pytest.mark.parametrize("workload", ["sprand-n5m-d5.square", "g500-s15-ef16.triangles",
                                      "sprand-n5m-d5.square-esc"])
def test_traced_tiny_run_reads_every_span_metric(tiny_root, workload):
    trace.reset()
    cell = load_cell(workload, tiny_root)
    r = run_cell(cell, seed=2**31 + 17, seconds=0.3, trace=True,
                 t_start=time.perf_counter(), device="cpu")
    want = {m["name"] for m in cell.per_layer} & set(SPAN_METRICS)
    assert want and want <= set(r["metrics"]), r["metrics"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["plan_search_s"] > 0 and m["plan_stage_s"] > 0 and m["call_host_ms"] > 0
    assert m["sort_slots_per_flop"] >= 1  # every candidate is sorted, padding too
    if workload.endswith("triangles"):
        assert m["syncs_per_call"] == 1 and m["input_check_ms"] > 0
    else:
        assert m["syncs_per_call"] == 0 and m["sync_wait_ms"] == 0
