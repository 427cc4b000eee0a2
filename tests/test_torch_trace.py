"""The port's trace, timer and debug utilities on the CPU, against the JAX
package's: ``roofline`` / ``bsr_roofline`` give the JAX functions' dicts on
the CPU, ``sort_rate_ns`` interpolates as the JAX function does on the same
table, an H100's name prices with the H100's rates, and ``trace``,
``measure_dispatch_floor``, ``BenchStats`` / ``bench_fn`` and ``format_csr``
run and agree with their JAX counterparts; the recorder (``span``,
``count``, ``tracing``) records the planner always and a call's spans and
counts only under a profiler or ``tracing()``, nested as the program's
layers."""
import json

import jax
import numpy as np
import pytest
import torch

from binary_spgemm_tpu import BCSR as JaxBCSR
from binary_spgemm_tpu.utils import debug as jx_debug
from binary_spgemm_tpu.utils import timers as jx_timers
from binary_spgemm_tpu.utils import trace as jx_trace

from binary_spgemm_tpu_torch import BCSR, EllSpGEMMExecutor, SpGEMMExecutor, auto_executor
from binary_spgemm_tpu_torch.ops import counts
from binary_spgemm_tpu_torch.utils import debug, timers, trace

H100 = "NVIDIA H100 80GB HBM3"
JAX_CPU = jax.devices("cpu")[0]


@pytest.mark.parametrize("sort_len", [None, 2, 4096, 1 << 20])
@pytest.mark.parametrize("floor_s", [None, 0.0005, 0.5])
def test_roofline_on_the_cpu_is_the_jax_dict(sort_len, floor_s):
    for flops_pad in (1, 3, 1 << 10, 1 << 20, 30_000_001):
        for nnz_a, nnz_c in ((0, 0), (1000, 5000)):
            for seconds in (0.0, 0.001, 0.1):
                kw = dict(sort_len=sort_len, floor_s=floor_s)
                want = jx_trace.roofline(flops_pad, nnz_a, nnz_c, seconds, JAX_CPU, **kw)
                for device in ("cpu", torch.device("cpu")):
                    assert trace.roofline(flops_pad, nnz_a, nnz_c, seconds, device,
                                          **kw) == want


@pytest.mark.parametrize("block_size", [8, 16, 100, 128])
def test_bsr_roofline_on_the_cpu_is_the_jax_dict(block_size):
    for n_pairs, n_out in ((0, 0), (1, 1), (1114, 1106), (10**6, 3)):
        for seconds in (0.0, 1e-4, 0.01):
            want = jx_trace.bsr_roofline(n_pairs, n_out, block_size, seconds, JAX_CPU)
            assert trace.bsr_roofline(n_pairs, n_out, block_size, seconds,
                                      "cpu") == want


@pytest.mark.parametrize("flat", [False, True])
def test_sort_rate_ns_interpolates_as_the_jax_function(monkeypatch, flat):
    monkeypatch.setattr(trace, "SORT_RATE_2D_NS", {"h100": dict(jx_trace.SORT_RATE_2D_NS)})
    monkeypatch.setattr(trace, "SORT_RATE_FLAT_NS",
                        {"h100": dict(jx_trace.SORT_RATE_FLAT_NS)})
    for L in (1, 128, 256, 300, 512, 777, 1024, 3968, 4096, 5000, 8192, 10**5,
              1 << 19, 1 << 21, 3_000_000, 1 << 25, 1 << 28):
        want = jx_trace.sort_rate_ns(L, flat=flat)
        assert trace.sort_rate_ns(L, flat=flat, kind=H100) == want
        assert trace.sort_rate_ns(L, flat=flat) == want


def test_an_h100_prices_with_the_h100s_rates():
    r = trace.roofline(1 << 20, 1000, 5000, 0.01, H100)
    assert r["bandwidth_assumed_gbps"] == 3350.0
    b = trace.bsr_roofline(1114, 1106, 128, 1e-4, H100)
    assert b["bandwidth_assumed_gbps"] == 3350.0 and b["mxu_assumed_tflops"] == 989.0
    # the dual roofline from the card's own measured table
    assert r["sort_rate_ns_per_elem"] == trace.sort_rate_ns(1 << 20, flat=True, kind=H100)
    assert r["sort_compute_s"] == 2 * (1 << 20) * r["sort_rate_ns_per_elem"] / 1e9
    assert r["fraction_of_dual"] == max(r["speed_of_light_s"], r["sort_compute_s"]) / 0.01
    assert "dispatch_floor_s" not in r  # no floor passed
    f = trace.roofline(1 << 20, 1000, 5000, 0.01, H100, floor_s=0.001)
    assert f["dispatch_floor_s"] == 0.001
    assert f["fraction_ex_dispatch"] == f["speed_of_light_s"] / (0.01 - 0.001)
    assert f["fraction_of_dual_device"] == max(f["speed_of_light_s"],
                                               f["sort_compute_s"]) / (0.01 - 0.001)
    # at or below the floor the fractions above it are meaningless: omitted
    assert "fraction_ex_dispatch" not in trace.roofline(1 << 20, 0, 0, 0.001, H100,
                                                        floor_s=0.001)


def test_a_card_without_a_table_has_no_dual_roofline(monkeypatch):
    monkeypatch.setattr(trace, "SORT_RATE_2D_NS", {})
    r = trace.roofline(1 << 20, 1000, 5000, 0.01, H100, floor_s=0.001)
    assert "fraction_of_dual" not in r and "fraction_of_dual_device" not in r
    assert "fraction_ex_dispatch" in r
    with pytest.raises(KeyError, match="no measured sort-rate table"):
        trace.sort_rate_ns(4096, kind=H100)
    assert "fraction_of_dual" not in trace.roofline(1 << 20, 0, 0, 0.01, "cpu")


def test_the_pinned_tables_are_h100_measurements():
    for table in (trace.SORT_RATE_2D_NS, trace.SORT_RATE_FLAT_NS):
        assert set(table) == {"h100"}
        assert all(r > 0 for r in table["h100"].values())
    assert sorted(trace.SORT_RATE_2D_NS["h100"]) == [256, 512, 1024, 2048, 4096, 8192]
    assert sorted(trace.SORT_RATE_FLAT_NS["h100"]) == [1 << n for n in (19, 20, 22, 23, 25)]
    assert 0 < trace.DISPATCH_FLOOR_S < 0.001
    assert set(trace.HBM_BYTES_PER_S) == {"h100", "cpu"}
    assert set(trace.BF16_FLOPS_PER_S) == {"h100", "cpu"}


@pytest.mark.parametrize("device,kind", [
    ("cpu", "cpu"), (torch.device("cpu"), "cpu"), (H100, "nvidia h100 80gb hbm3"),
    ("h100", "h100")])
def test_device_kind(device, kind):
    assert trace.device_kind(device) == kind


def _mat(n=3000, d=4.0, seed=1):
    return BCSR.random(n, n, d, seed=seed)


def _sym_graph(n, d, seed):
    """A symmetric adjacency with an empty diagonal."""
    s = BCSR.random(n, n, d, seed=seed).to_scipy()
    s = ((s + s.T) > 0).astype(np.int64).tolil()
    s.setdiag(0)
    return BCSR.from_scipy(s.tocsr())


def _batched(a):
    return EllSpGEMMExecutor(a, a, batched=True, deal_k=64, device="cpu")


def test_spans_off_outside_a_profiler():
    ex = _batched(_mat())
    trace.reset()
    ex.run()
    assert trace.spans() == [] and trace.dropped == 0
    assert trace.span("call.run") is trace.span("sort")  # one shared no-op
    with trace.span("call.run") as s:
        trace.count("sort.slots", 5)
    assert trace.spans() == []
    assert s is trace.span("expand")


@pytest.mark.parametrize("route", ["auto", "batched", "esc"])
def test_plan_spans_record_with_tracing_off(route):
    a = _mat()
    trace.reset()
    if route == "auto":
        auto_executor(a, a, device="cpu")
    elif route == "batched":
        _batched(a)
    else:
        SpGEMMExecutor(a, a, chunk_flops=1 << 14, device="cpu")
    spans = trace.spans()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["plan"]  # the executor's own plan nests nothing
    plan = roots[0]
    inner = [s for s in spans if s is not plan]
    assert all(s.parent == plan.id and s.call == plan.id for s in inner)
    want = {"plan.search", "plan.stage"} | ({"plan.tables"} if route != "esc" else set())
    assert {s.name for s in inner} == want
    assert all(plan.t0 <= s.t0 <= s.t1 <= plan.t1 for s in inner)
    assert all(s.counts == {} for s in spans)
    # the three phases follow one another and never overlap
    inner.sort(key=lambda s: s.t0)
    assert all(x.t1 <= y.t0 for x, y in zip(inner, inner[1:]))


def test_one_run_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    ex = _batched(_mat())
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex.run()
    spans = trace.spans()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["call.run"]
    root = roots[0]
    inner = [s for s in spans if s is not root]
    assert all(s.call == root.id and s.parent == root.id for s in inner)
    for name in ("expand", "sort", "compress"):
        assert sum(s.name == name for s in inner) == ex.n_groups
    # each span is a range of the profiler's timeline around the ops it ran
    events = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()]
    ranges = {name: [(t0, t1) for t0, t1, n in events if n == name]
              for name in ("call.run", "expand", "sort", "compress")}
    assert {k: len(v) for k, v in ranges.items()} == {
        "call.run": 1, "expand": ex.n_groups, "sort": ex.n_groups,
        "compress": ex.n_groups}
    sorts = [(t0, t1) for t0, t1, n in events if n == "aten::sort"]
    assert len(sorts) == 2 * ex.n_groups
    for t0, t1 in sorts:  # the first sort of a group in "sort", the second in "compress"
        assert any(r0 <= t0 and t1 <= r1 for r0, r1 in ranges["sort"] + ranges["compress"])
    for r0, r1 in ranges["sort"] + ranges["expand"]:
        assert any(r0 <= t0 and t1 <= r1 for t0, t1, n in events if n.startswith("aten::"))
    (c0, c1), = ranges["call.run"]
    assert all(c0 <= t0 and t1 <= c1 for t0, t1, n in events if n.startswith("aten::"))


@pytest.mark.parametrize("route", ["batched", "esc"])
def test_sort_slots_of_one_run(route):
    a = _mat()
    if route == "batched":
        ex = _batched(a)
        want = 2 * ex.n_groups * ex.group_size * ex.sort_pad
    else:
        ex = SpGEMMExecutor(a, a, chunk_flops=1 << 14, device="cpu")
        want = 2 * len(ex.chunks) * (ex.flops_pad + ex._rows_pad)
    trace.reset()
    with trace.tracing():
        out = ex.run()
    (root,) = [s for s in trace.spans() if s.parent is None]
    assert root.name == "call.run" and root.counts == {"sort.slots": want}
    ref = a.to_scipy() @ a.to_scipy()
    ref.sort_indices()
    assert np.array_equal(ex.assemble(out).indices, ref.indices)


def test_triangle_count_reads_back_once_a_call():
    g = _sym_graph(400, 5.0, 46)
    s = g.to_scipy()
    want = int(s.multiply(s @ s).sum()) // 6
    assert counts.triangle_count_device(g, device="cpu") == want  # plans, untraced
    trace.reset()
    with trace.tracing():
        got = [counts.triangle_count_device(g, device="cpu") for _ in range(2)]
    assert got == [want, want]
    spans = trace.spans()
    roots = [r for r in spans if r.parent is None]
    assert [r.name for r in roots] == ["call.triangle_count"] * 2
    for r in roots:
        inner = [x for x in spans if x.call == r.id and x is not r]
        assert [x.name for x in inner if x.name.startswith("sync.")] == ["sync.sums"]
        assert [x.name for x in inner if x.name == "call.check"] == ["call.check"]
        assert "call.run_counts_sum" in {x.name for x in inner}
        assert r.counts["sort.slots"] > 0


def test_counts_nest_and_the_bound_counts_drops():
    trace.reset()
    with trace.tracing():
        with trace.span("call.x") as outer:
            trace.count("n", 2)
            with trace.span("inner") as inner:
                trace.count("n")
                assert trace.span("inner") is trace.span("call.x")  # re-entered: none
        with trace.tracing():  # nests
            pass
        assert trace.span("y") is not trace.span("y")
    assert trace.span("y") is trace.span("z")
    by_name = {s.name: s for s in trace.spans()}
    assert by_name["call.x"].counts == {"n": 3} and by_name["inner"].counts == {"n": 1}
    assert by_name["inner"].parent == outer.id == by_name["inner"].call
    assert inner.id == by_name["inner"].id
    trace.reset()
    extra = 3
    with trace.tracing():
        for _ in range(trace.SPANS_MAX + extra):
            with trace.span("s"):
                pass
    assert trace.dropped == extra and len(trace.spans()) == trace.SPANS_MAX
    trace.reset()
    assert trace.dropped == 0 and trace.spans() == []


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with trace.trace(str(logdir)):
        torch.arange(1000).sum()
    with open(logdir / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_measure_dispatch_floor_on_the_cpu():
    floor = trace.measure_dispatch_floor(reps=3, device="cpu")
    assert 0 < floor < 1.0


@pytest.mark.parametrize("times", [[0.3], [0.5, 0.1, 0.2], [1.0, 2.0, 3.0, 4.0]])
def test_bench_stats_are_the_jax_ones(times):
    got, want = timers.BenchStats(list(times)), jx_timers.BenchStats(list(times))
    assert (got.mean, got.median, got.fastest) == (want.mean, want.median, want.fastest)


def test_bench_fn_calls_the_barrier_before_each_run():
    calls = []
    stats = timers.bench_fn(lambda: calls.append("fn"), repeats=3,
                            barrier=lambda: calls.append("barrier"))
    assert calls == ["barrier", "fn"] * 3
    assert len(stats.times) == 3 and all(t >= 0 for t in stats.times)
    with timers.Timer() as t:
        pass
    assert t.seconds >= 0


@pytest.mark.parametrize("n,block", [(2, None), (4, 2), (5, 2), (6, 3), (9, 4), (7, None)])
def test_format_csr_is_the_jax_one(n, block):
    dense = (np.random.default_rng(n).random((n, n + 1)) < 0.4).astype(np.int8)
    got = debug.format_csr(BCSR.from_dense(dense), block=block)
    assert got == jx_debug.format_csr(JaxBCSR.from_dense(dense), block=block)


def test_format_csr_too_large():
    with pytest.raises(ValueError, match="too large"):
        debug.format_csr(BCSR.random(2000, 2000, 1.0, seed=0))


def test_print_csr(capsys):
    debug.print_csr(BCSR.from_dense(np.eye(2, dtype=np.int8)))
    assert capsys.readouterr().out.startswith("1 .\n. 1")



def test_k_truss_spans_and_counts():
    """The resident peel under ``tracing()``: one ``call.k_truss`` root a
    call with its input check, a ``ktruss.round`` a support round (as many
    as the plain reference's peel), each holding ``ktruss.support``,
    ``ktruss.filter`` and its one read ``sync.peel``; the result read once;
    ``ktruss.rounds`` and ``ktruss.dropped`` counted on the root."""
    from binary_spgemm_tpu_torch.ops import graph
    from spgemm_bench import ktruss_reference

    g = _sym_graph(300, 12.0, 47)
    ref = ktruss_reference.peel(g.indptr, g.indices, g.n_rows, 4, "cpu")
    assert ref.rounds >= 3
    for chunk_flops in (None, 4096):
        graph.k_truss(g, 4, chunk_flops=chunk_flops, device="cpu")  # plans, untraced
        trace.reset()
        with trace.tracing():
            got = graph.k_truss(g, 4, chunk_flops=chunk_flops, device="cpu")
        assert got.nnz == len(ref.indices)
        spans = trace.spans()
        (root,) = [s for s in spans if s.parent is None]
        assert root.name == "call.k_truss"
        assert root.counts["ktruss.rounds"] == ref.rounds
        assert root.counts["ktruss.dropped"] == g.nnz - got.nnz
        assert root.counts["sort.slots"] > 0
        inner = [s for s in spans if s.call == root.id and s is not root]
        rounds = [s for s in inner if s.name == "ktruss.round"]
        assert len(rounds) == ref.rounds
        for r in rounds:
            kids = [s.name for s in inner if s.parent == r.id]
            assert kids == ["ktruss.support", "ktruss.filter", "sync.peel"]
        assert [s.name for s in inner if s.parent == root.id
                and s.name != "ktruss.round"] == ["call.check", "sync.result"]
