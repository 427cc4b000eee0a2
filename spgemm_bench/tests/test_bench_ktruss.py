"""The two cells after the first four: ``sprand-n5m-d5.to-host`` (the
one-shot ``spgemm`` to a host CSR) and ``g500-s15-ef16-ktruss32.peel`` (the
device-resident k-truss peel), at tiny size on the CPU: each comes out
correct as it is and not correct with a fault planted in its timed path,
its control fails, the k-truss op's check and control hold on a graph of
known answer, and the peel's three metrics read the program's spans."""
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from binary_spgemm_tpu_torch.utils import trace
from spgemm_bench import compare, control, gen, ktruss_reference, ops
from spgemm_bench.harness import run_cell
from spgemm_bench.spec import load_cell

from . import faults

BENCH = Path(__file__).resolve().parents[1]
TO_HOST, PEEL = "sprand-n5m-d5.to-host", "g500-s15-ef16-ktruss32.peel"
SEED = 2**31 + 17
MS = 1_000_000  # nanoseconds


def _device_route():
    """The one-shot ``spgemm`` on the device at tiny size: no host engine."""
    from binary_spgemm_tpu_torch.ops import host

    faults._set(host, "HOST_MAX_FLOPS", 0)


def to_host_answer_altered():
    _device_route()
    faults.product_answer_altered()


def to_host_half_left_out():
    _device_route()
    faults.product_half_left_out()


def peel_answer_altered():
    """The truss's first entry moved to the next column."""
    from binary_spgemm_tpu_torch.ops import graph

    def fix(args, c):
        idx = c.indices.copy()
        idx[0] = (idx[0] + 1) % c.n_cols
        return type(c)(c.indptr, idx, c.shape)

    faults._wrap(graph, "k_truss_device", fix)


def peel_stopped_after_one_round():
    """Every round after a call's first (the plan's own spans) gives every
    entry a support past any bound, so each peel stops at its second
    round."""
    from binary_spgemm_tpu_torch.ops import truss

    def fix(args, out):
        _, _, _, support, pads = args
        if pads is not None:
            support.fill_(1 << 30)
        return out

    faults._wrap(truss._EllLayout, "support", fix)


CASES = [(TO_HOST, _device_route, True), (TO_HOST, to_host_answer_altered, False),
         (TO_HOST, to_host_half_left_out, False), (PEEL, None, True),
         (PEEL, peel_answer_altered, False), (PEEL, peel_stopped_after_one_round, False)]


def _run(root, workload, *, trace_on=False, patch=None, seed=SEED):
    cell = load_cell(workload, root)
    try:
        return run_cell(cell, seed=seed, seconds=0.3, trace=trace_on,
                        t_start=time.perf_counter(), device="cpu", patch=patch)
    finally:
        faults.undo()


@pytest.mark.parametrize("workload,patch,sound", CASES,
                         ids=[f"{w}-{p.__name__ if p else 'sound'}" for w, p, _ in CASES])
def test_new_cell_is_judged(tiny_root, workload, patch, sound):
    r = _run(tiny_root, workload, patch=patch)
    assert r["correct"] is sound, r["checks"]
    assert set(r["checks"]) == {"rows_wrong", "nnz_gap"} and r["attempted"] >= 1
    if sound:
        assert set(r["metrics"]) == {"flop_rate", "call_p95_ms", "setup_s"}


@pytest.mark.parametrize("workload", [TO_HOST, PEEL])
@pytest.mark.parametrize("seed", [3, 2**31 + 1])
def test_new_cell_control_fails(tiny_root, workload, seed):
    correct, checks = control.control(load_cell(workload, tiny_root), seed, "cpu")
    assert correct is False
    assert any(c["value"] > c["limit"] for c in checks.values())


def _clique_and_fan():
    """K5 on vertices 0-4, and a fan off vertex 4: the path 5-6-7 with 4
    adjacent to each.  At k = 4 (support 2) the first round drops every fan
    edge but (4, 6), whose two triangles ran through them; the second drops
    it; the third drops nothing.  The truss is the clique."""
    edges = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    edges += [(4, 5), (4, 6), (4, 7), (5, 6), (6, 7)]
    keys = sorted({i * 8 + j for a, b in edges for i, j in ((a, b), (b, a))})
    rows, cols = np.divmod(np.array(keys, np.int64), 8)
    indptr = np.zeros(9, np.int64)
    np.cumsum(np.bincount(rows, minlength=8), out=indptr[1:])
    return indptr, cols.astype(np.int32), 8


def test_ktruss_op_check_and_control_on_a_known_graph():
    from spgemm_bench.ops import ktruss as op

    inputs = _clique_and_fan()
    t = ktruss_reference.peel(*inputs, 4, "cpu")
    assert (t.rounds, t.nnz, len(t.indices)) == (3, [30, 22, 20], 20)
    assert t.flops == [130, 90, 80] and t.flops[0] == gen.flops(*inputs[:2])
    answer = ops.csr_of_blocks([(0, 8, t.keys)], 8)
    holder = op.Op.__new__(op.Op)
    holder.truss = t
    numbers, extra = holder.check([answer], inputs, "cpu")
    assert compare.judge(numbers)[0] is True
    assert extra["bytes_needed"] == 4 * 9 * 4 + (30 + 22 + 20 + 20) * 4
    # cut after one round, (4, 6) is still there: rows 4 and 6 wrong
    assert op.Op.control({"k": 4}, inputs, "cpu") == {"rows_wrong": 2, "nnz_gap": 2}


def _metric(name):
    spec = importlib.util.spec_from_file_location(f"t_peel_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def S(id, parent, call, name, t0, t1, counts=None):
    return trace.Span(id, parent, call, name, t0 * MS, t1 * MS, counts or {})


# two traced peels: three rounds of 10, 20 and 30 ms, then two of 40 ms
PEEL_SPANS = [
    S(2, 1, 1, "ktruss.round", 0, 10), S(3, 2, 1, "ktruss.filter", 8, 9),
    S(4, 1, 1, "ktruss.round", 10, 30), S(5, 4, 1, "ktruss.filter", 28, 30),
    S(6, 1, 1, "ktruss.round", 30, 60), S(7, 6, 1, "ktruss.filter", 58, 59),
    S(1, None, 1, "call.k_truss", 0, 61, {"ktruss.rounds": 3}),
    S(9, 8, 8, "ktruss.round", 70, 110), S(10, 9, 8, "ktruss.filter", 100, 102),
    S(11, 8, 8, "ktruss.round", 110, 150), S(12, 11, 8, "ktruss.filter", 140, 142),
    S(8, None, 8, "call.k_truss", 70, 151, {"ktruss.rounds": 2}),
]
REC = {"trace": [{"calls": 2}], "flops": 100}


@pytest.mark.parametrize("name,want", [("peel_rounds", 2.5), ("peel_round_ms", 28.0),
                                       ("peel_filter_ms", 4.0)])
def test_peel_metrics_on_recorded_spans(monkeypatch, name, want):
    monkeypatch.setattr(trace, "spans", lambda: list(PEEL_SPANS))
    monkeypatch.setattr(trace, "dropped", 0)
    assert _metric(name)(REC) == pytest.approx(want)
    # a window of calls that are not peels: nothing to read
    others = [S(20, None, 20, "call.run", 200, 201), S(21, None, 21, "call.run", 202, 203)]
    monkeypatch.setattr(trace, "spans", lambda: list(PEEL_SPANS) + others)
    assert _metric(name)(REC) is None
    monkeypatch.setattr(trace, "dropped", 1)
    assert _metric(name)(REC) is None
    monkeypatch.delattr(trace, "spans")  # a program without the recorder
    assert _metric(name)(REC) is None


def test_traced_tiny_peel_reads_every_metric_it_lists(tiny_root):
    trace.reset()
    cell = load_cell(PEEL, tiny_root)
    r = run_cell(cell, seed=SEED, seconds=0.3, trace=True, t_start=time.perf_counter(),
                 device="cpu")
    assert r["correct"] is True, r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    listed = {p["name"] for p in cell.per_layer}
    # no class-table gather on the CPU's plain torch version; no device trace
    assert listed - set(m) <= {"gather_ms", "sort_ms", "compress_ms", "step_roofline",
                               "launches_per_call", "device_idle_share"}
    inputs = gen.generate(cell.config, SEED)
    rounds = ktruss_reference.peel(*inputs, int(cell.mix["k"]), "cpu").rounds
    assert m["peel_rounds"] == rounds >= 5
    assert m["syncs_per_call"] == rounds + 1  # a read a round, and the result
    assert m["peel_round_ms"] > 0 and m["peel_filter_ms"] > 0 and m["input_check_ms"] > 0
    assert m["sort_slots_per_flop"] > 0 and m["plan_stage_s"] > 0


def test_reference_peel_is_the_dense_peel():
    rng = np.random.default_rng(4)
    d = rng.random((60, 60)) < 0.25
    d = np.triu(d, 1)
    d = d | d.T
    rows, cols = np.nonzero(d)
    indptr = np.zeros(61, np.int64)
    np.cumsum(np.bincount(rows, minlength=60), out=indptr[1:])
    for k in (3, 4, 5, 6):
        want = d.astype(np.int64)
        while True:
            drop = ((want @ want) * want < k - 2) & (want > 0)
            if not drop.any():
                break
            want[drop] = 0
        got = ktruss_reference.peel(indptr, cols.astype(np.int32), 60, k, "cpu",
                                    block_flops=64)
        dense = np.zeros((60, 60), bool)
        dense[np.repeat(np.arange(60), np.diff(got.indptr)), got.indices] = True
        assert np.array_equal(dense, want > 0)
        assert torch.equal(got.keys, torch.from_numpy(np.flatnonzero(want.ravel() > 0)))
