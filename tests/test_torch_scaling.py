"""The port's scaling report (``parallel/scaling.py``) against the JAX
package's, on the CPU.

JAX runs ``scaling_report`` on its virtual CPU devices; the port's six
reports (engine esc / ell × B layout replicated / sharded / ring) run in one
group of two gloo ranks (one launch), at ``device_counts=[1, 2]`` on
``BCSR.random(1500, 1500, 3.0, seed=4)``.  The keys of each report and of
each row equal JAX's, ``compute_s`` is ``None`` exactly where JAX's is, both
are bit-exact, and every plan field of every row equals JAX's at the same
count.  No plan field differs on these inputs; the port's ESC pad differs
from JAX's by design only where JAX's would truncate a shard's expansion
(``test_esc_pad_never_truncates``).
"""
import numpy as np
import pytest
import torch

import binary_spgemm_tpu as jx
from binary_spgemm_tpu.parallel.scaling import format_scaling_report as jx_format
from binary_spgemm_tpu.parallel.scaling import scaling_report as jx_report

import binary_spgemm_tpu_torch as tp
from binary_spgemm_tpu_torch.ops.spgemm import pad_bucket, row_flops
from binary_spgemm_tpu_torch.parallel import scaling
from binary_spgemm_tpu_torch.parallel.launch import launch
from binary_spgemm_tpu_torch.parallel.mesh import RowMesh, partition_rows

import _torch_dist_cases

COMBOS = [(e, lay) for e in ("esc", "ell") for lay in ("replicated", "sharded", "ring")]
PLAN = ("devices", "rows_pad", "flops_pad", "step_pad", "sort_pad", "batched",
        "sub_chunks", "padded_slots_per_shard", "padded_work_total", "work_vs_1dev")
SAME = ("kind", "engine", "b_layout", "n", "input_nnz", "flops", "balance", "platform",
        "host_cores", "efficiency_target", "meets_target_scope")


@pytest.fixture(scope="module")
def matrices():
    ja = jx.BCSR.random(1500, 1500, 3.0, seed=4)
    return ja, tp.bcsr_from_arrays(ja.indptr, ja.indices, ja.shape)


@pytest.fixture(scope="module")
def port_reports(matrices):
    """Every rank's six reports from one launch of two gloo ranks."""
    return launch(_torch_dist_cases.scaling_reports, 2, matrices[1], COMBOS,
                  {"device_counts": [1, 2], "times": 1}, device="cpu", timeout=600)


@pytest.mark.parametrize("engine, layout", COMBOS)
def test_report_matches_jax(matrices, port_reports, engine, layout):
    j = jx_report(matrices[0], engine=engine, b_layout=layout, device_counts=[1, 2],
                  times=1)
    t = port_reports[0][(engine, layout)]
    assert port_reports[1][(engine, layout)] == t  # every rank gets rank 0's
    assert sorted(t) == sorted(j)
    assert {k: t[k] for k in SAME} == {k: j[k] for k in SAME}
    assert t["bit_exact"] is True and j["bit_exact"] is True
    assert isinstance(t["meets_target"], bool) and t["floor_s"] > 0
    assert [r["devices"] for r in t["rows"]] == [1, 2]
    for rj, rt in zip(j["rows"], t["rows"], strict=True):
        assert sorted(rt) == sorted(rj)
        assert (rt["compute_s"] is None) == (rj["compute_s"] is None)
        assert (rt["collective_s"] is None) == (rj["collective_s"] is None)
        assert {k: rt.get(k) for k in PLAN} == {k: rj.get(k) for k in PLAN}
        assert rt["step_s"] > 0 and rt["efficiency"] > 0
        if rt["compute_s"] is not None:
            assert rt["compute_s"] > 0 and rt["collective_s"] >= 0
    assert t["rows"][0]["efficiency"] == 1.0 and t["rows"][0]["speedup"] == 1.0
    txt = scaling.format_scaling_report(t)
    assert engine in txt and layout in txt and "target" in txt
    assert txt.splitlines()[1] == jx_format(j).splitlines()[1]
    assert len(txt.splitlines()) == len(jx_format(j).splitlines())


def test_one_rank_runs_in_this_process(matrices, monkeypatch):
    """``device_counts=[1]`` needs no group: no rank is started."""
    monkeypatch.setattr("binary_spgemm_tpu_torch.parallel.launch.launch",
                        lambda *a, **k: pytest.fail("a rank was started"))
    t = scaling.scaling_report(matrices[1], device_counts=[1], times=1, device="cpu")
    j = jx_report(matrices[0], device_counts=[1], times=1)
    assert sorted(t) == sorted(j) and t["bit_exact"] is True
    assert {k: t["rows"][0].get(k) for k in PLAN} == {k: j["rows"][0].get(k) for k in PLAN}
    assert t["meets_target"] is False  # no count past one rank to judge


def test_gate_over_cards_and_cores():
    """``meets_target`` reads the normalised efficiency of the counts up to
    the card count (the cores on the CPU); past it the report names the
    cards and says the sizes measure sharing, not scaling."""
    rows = [{"devices": 1, "efficiency_norm": 1.0},
            {"devices": 2, "efficiency_norm": 0.9},
            {"devices": 4, "efficiency_norm": 0.1}]
    g = scaling._gate(rows, 4, "cuda", 2, 64)
    assert g["meets_target"] is True and g["cards"] == 2
    assert g["meets_target_scope"] == "devices<=2 (cards)"
    assert "card sharing, not scaling" in g["artifact_note"]
    g = scaling._gate(rows[:1], 4, "cuda", 1, 64)
    assert g["meets_target"] is False and g["cards"] == 1
    g = scaling._gate(rows, 4, "cuda", 4, 64)
    assert g == {"meets_target": False, "meets_target_scope": "all mesh sizes"}
    g = scaling._gate(rows, 4, "cpu", None, 2)
    assert g["meets_target"] is True and "cards" not in g
    assert g["meets_target_scope"] == "devices<=2 (physical cpu cores)"
    assert "oversubscription" in g["artifact_note"]
    rows[1]["efficiency_norm"] = 0.79
    assert scaling._gate(rows, 4, "cpu", None, 2)["meets_target"] is False


def test_esc_pad_never_truncates():
    """The JAX package pads each shard's ESC expansion to the product's
    bucket over the shards; where a shard holds more flops than that
    (rows balance on a skewed matrix) the port raises the pad to that
    shard's bucket, so the timed step computes the whole product (JAX's
    would here, on rmat at either balance)."""
    a = tp.BCSR.rmat(10, 8.0, seed=1)
    rf = row_flops(a, a)
    flops_pad1 = pad_bucket(int(rf.sum()))
    bounds = partition_rows(rf, 4, balance="rows")
    need = max(int(rf[r0:r1].sum()) for r0, r1 in zip(bounds, bounds[1:]))
    assert need > flops_pad1 // 4  # JAX's pad would truncate this shard
    mesh = RowMesh(None, 0, 4, torch.device("cpu"))
    _, _, meta = scaling._build_step(a, a, "esc", "replicated", mesh, "rows",
                                     flops_pad1, rf)
    assert meta["flops_pad"] == pad_bucket(need) >= need
    u = tp.BCSR.random(1500, 1500, 3.0, seed=4)
    rf = row_flops(u, u)
    flops_pad1 = pad_bucket(int(rf.sum()))
    _, _, meta = scaling._build_step(u, u, "esc", "replicated", mesh, "flops",
                                     flops_pad1, rf)
    assert meta["flops_pad"] == flops_pad1 // 4  # JAX's pad where it suffices


def test_arguments_are_checked(matrices):
    for kw, match in (({"engine": "auto"}, "unknown engine"),
                      ({"b_layout": "ring2"}, "unknown b_layout"),
                      ({"device_counts": [0, 1]}, "positive")):
        with pytest.raises(ValueError, match=match):
            scaling.scaling_report(matrices[1], device="cpu", **kw)
    assert np.isclose(scaling.EFFICIENCY_TARGET, 0.8)
