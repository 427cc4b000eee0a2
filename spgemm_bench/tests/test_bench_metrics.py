"""The metric arithmetic on made-up records: one test a metric file."""
import importlib.util
import json
from pathlib import Path

import pytest

from spgemm_bench import classify, latency, roofline, timeline

BENCH = Path(__file__).resolve().parents[1]


def _load(kind, name):
    spec = importlib.util.spec_from_file_location(f"t_{kind}_{name}", BENCH / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(by_name, *, calls=2, busy=0.010, span=0.012, ops=10):
    return {"calls": calls, "wall_s": 0.02, "busy_s": busy, "span_s": span,
            "device_ops": ops, "by_name": by_name, "gaps": {}}


KERNELS = {
    "void (anonymous namespace)::sort_rows_wide_kernel<13, 5, true, false>(int const*)": 0.004,
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail::cub::Dev": 0.002,
    "void (anonymous namespace)::class_gather_group_kernel<true>((anonymous namespace": 0.001,
    "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)": 0.0005,
    "Memcpy DtoD (Device -> Device)": 0.0003,
    "void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<int,": 0.0012,
}


def test_window_rate():
    rec = {"flops": 125_000_000, "calls": 200, "window_s": 2.5}
    assert _load("e2e", "flop_rate").compute(rec) == pytest.approx(10.0)


def test_p95_over_all_calls():
    lat = [i / 1000 for i in range(1, 101)]  # 1..100 ms
    assert latency.percentile(lat, 95) == pytest.approx(0.095)
    assert latency.percentile([0.5], 95) == 0.5
    assert _load("e2e", "call_p95_ms").compute({"latency_s": lat}) == pytest.approx(95.0)
    with pytest.raises(ValueError):
        latency.percentile([], 95)


def test_slowest_rank_latency():
    assert latency.slowest_rank([[1, 5, 2], [3, 1, 2], [2, 2, 9]]) == [3, 5, 9]
    with pytest.raises(ValueError):
        latency.slowest_rank([[1, 2], [1]])


def test_peak_and_setup():
    assert _load("e2e", "peak_mem_gib").compute({"peak_bytes": 3 * 2**30}) == 3.0
    assert _load("e2e", "peak_mem_gib").compute({"peak_bytes": None}) is None
    assert _load("e2e", "setup_s").compute({"setup_s": 12.5}) == 12.5


def test_idle_share_from_a_timeline():
    busy, span, gaps = timeline.busy_and_gaps([(0, 4), (2, 6), (8, 10), (10, 11)])
    assert (busy, span, gaps) == (9, 11, [(6, 8)])
    assert timeline.busy_and_gaps([]) == (0.0, 0.0, [])
    host = [(0, 20, "bench.call"), (5, 9, "aten::nonzero"), (6, 6.5, "cudaMemcpyAsync")]
    assert timeline.name_gaps([(6, 8), (15, 16), (30, 31)], host) == {
        "aten::nonzero": 2, "bench.call": 1, "host idle": 1}
    events = [(True, 0, 4, "k1"), (True, 2, 6, "k2"), (True, 8, 10, "k1"),
              (False, 0, 20, "bench.call"), (True, 3, 3, "empty")]
    s = timeline.summarize(events, calls=2, wall_s=30e-6)
    assert s["device_ops"] == 3
    assert s["busy_s"] == pytest.approx(8e-6) and s["span_s"] == pytest.approx(10e-6)
    assert s["by_name"] == pytest.approx({"k1": 6e-6, "k2": 4e-6})
    assert s["gaps"] == pytest.approx({"bench.call": 2e-6})
    rec = {"trace": [_summary({}, busy=0.003, span=0.004), _summary({}, busy=0.001, span=0.002)]}
    assert _load("metrics", "device_idle_share").read(rec) == pytest.approx(37.5)
    assert timeline.top({"a": 1, "b": 3, "c": 2}, 2) == [["b", 3], ["c", 2]]


def test_step_roofline_bytes():
    assert roofline.csr_bytes(10, 7) == 11 * 4 + 7 * 4
    assert roofline.csr_bytes(10, 2**31) == 11 * 8 + 2**31 * 4
    assert roofline.square_product_bytes(5, 10, 20) == 6 * 4 + 40 + 6 * 4 + 80
    rec = {"trace": [_summary({}, calls=4, busy=0.004)], "bytes_needed": 3.35e9, "chips": 1}
    assert _load("metrics", "step_roofline").read(rec) == pytest.approx(100.0)
    rec["chips"] = 4  # four cards move four times the bytes
    assert _load("metrics", "step_roofline").read(rec) == pytest.approx(25.0)
    assert _load("metrics", "step_roofline").read({**rec, "bytes_needed": None}) is None


def test_kernel_classifier():
    s = _summary(KERNELS, calls=2)
    assert classify.device_seconds(s, classify.patterns_of("sort_ms")) == pytest.approx(0.006)
    assert classify.device_seconds(s, ["nothing"]) is None
    rec = {"trace": [s, _summary({k: 2 * v for k, v in KERNELS.items()}, calls=2)]}
    assert _load("metrics", "sort_ms").read(rec) == pytest.approx(6.0)  # slowest rank
    assert _load("metrics", "gather_ms").read(rec) == pytest.approx(1.0)
    assert _load("metrics", "collective_ms").read(rec) == pytest.approx(0.5)
    assert _load("metrics", "compress_ms").read(rec) == pytest.approx(1.5)
    assert _load("metrics", "sort_ms").read({"trace": None}) is None
    assert _load("metrics", "collective_ms").read({"trace": [_summary({"k": 1.0})]}) is None


def test_counts_and_host_metrics():
    rec = {"trace": [_summary({}, calls=4, ops=40, busy=0.008), _summary({}, calls=4, ops=48,
                                                                           busy=0.004)],
           "plan_s": 1.5, "enqueue_s": [0.001, 0.003], "comm_bytes": 8_000_000, "calls": 4}
    assert _load("metrics", "launches_per_call").read(rec) == pytest.approx(11.0)
    assert _load("metrics", "plan_s").read(rec) == 1.5
    assert _load("metrics", "enqueue_ms").read(rec) == pytest.approx(2.0)
    assert _load("metrics", "comm_mb_per_step").read(rec) == pytest.approx(2.0)
    assert _load("metrics", "rank_skew").read(rec) == pytest.approx(2 / 1.5)
    assert _load("metrics", "rank_skew").read({"trace": rec["trace"][:1]}) is None
    assert _load("metrics", "comm_mb_per_step").read({"comm_bytes": None}) is None
    assert _load("metrics", "launches_per_call").read(
        {"trace": [_summary({}, ops=0)]}) is None


def test_every_metric_has_its_file_and_unit():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"]:
        assert callable(_load("e2e", m["name"]).compute)
    for m in bench["per_layer"]:
        assert callable(_load("metrics", m["name"]).read)
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
