"""The port's benchmark drivers on the CPU: ``emit`` refuses exactly the rows
the JAX package's ``emit`` refuses and writes to the file it is given,
``pallas_sort --check`` runs, every driver that measures refuses to run
without a card, and ``sort_fraction`` reads the roofline as the JAX one does."""
import importlib.util
import json
import os
import types

import pytest

from binary_spgemm_tpu_torch.benchmarks import (
    _provenance, ab_wruns, pallas_gather, pallas_sort, sort_rate_table)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_provenance():
    spec = importlib.util.spec_from_file_location(
        "_reference_provenance", os.path.join(ROOT, "benchmarks", "_provenance.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROWS = [
    {"t": 1.0},
    {"t": 1.0, "bit_exact": None},
    {"t": 1.0, "bit_exact": "n/a"},
    {"t": 1.0, "bit_exact": "yes"},
    {"fastest_s": 0.5, "bit_exact": 1},
    {"ns_per_elem": 0.2, "bit_exact": True},
    {"rate_ns_per_elem": 0.2},
    {"seconds": 2.0, "bit_exact": False},
    {"error": "ValueError: no", "t": 1.0},
    {"k": 3, "L": 4096},
    {"ns_per_slot": 0.1},
    {"sort_device_s": 0.1, "bit_exact": "n/a"},
]


@pytest.mark.parametrize("row", ROWS, ids=[json.dumps(r) for r in ROWS])
def test_emit_refuses_where_the_jax_emit_refuses(jax_provenance, tmp_path, monkeypatch,
                                                 row):
    jax_path, path = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    monkeypatch.setattr(jax_provenance, "RESULTS", str(jax_path))
    assert _provenance.is_timed(dict(row)) == jax_provenance.is_timed(dict(row))
    try:
        jax_provenance.emit(dict(row))
        refused = False
    except ValueError:
        refused = True
    if refused:
        with pytest.raises(ValueError, match="bit_exact"):
            _provenance.emit(dict(row), path=str(path))
        assert not path.exists()
        return
    got = _provenance.emit(dict(row), path=str(path))
    lines = path.read_text().splitlines()
    assert [json.loads(x) for x in lines] == [got]
    assert {k: got[k] for k in row} == row
    assert "ts" in got and "card" in got  # the card: None without nvidia-smi


def test_emit_appends(tmp_path):
    path = tmp_path / "rows.jsonl"
    for i in range(3):
        _provenance.emit({"i": i, "t": 0.1, "bit_exact": True}, path=str(path))
    assert [json.loads(x)["i"] for x in path.read_text().splitlines()] == [0, 1, 2]


def test_rows_default_to_the_ports_own_files():
    here = os.path.dirname(_provenance.__file__)
    assert _provenance.RESULTS == os.path.join(here, "results.jsonl")
    assert _provenance.MICRO == os.path.join(here, "micro.jsonl")
    assert os.path.basename(here) == "benchmarks"
    assert "binary_spgemm_tpu_torch" in here


def test_pallas_sort_check_runs_on_the_cpu(capsys):
    assert pallas_sort.main(["--check"]) == []
    out = capsys.readouterr().out
    assert out.count("plain ok") == len(pallas_sort.CHECK_SHAPES)


def test_driver_shapes_are_the_prototypes():
    assert pallas_sort.SHAPES == [(8192, 2048), (65536, 2048), (16384, 8192)]
    assert (ab_wruns.K, ab_wruns.L, ab_wruns.W, ab_wruns.SEED) == (32768, 4096, 16, 17)
    assert (pallas_gather.T, pallas_gather.W, pallas_gather.E, pallas_gather.SHIFT) == (
        1 << 16, 16, 1 << 20, 17)
    assert sort_rate_table.LENGTHS_2D == (256, 512, 1024, 2048, 4096, 8192)


@pytest.mark.parametrize("driver", [pallas_sort, ab_wruns, sort_rate_table, pallas_gather])
def test_drivers_measure_a_card_or_nothing(driver, tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    path = tmp_path / "rows.jsonl"
    with pytest.raises(RuntimeError, match="CUDA card"):
        driver.main(["--results", str(path)])
    assert not path.exists()


@pytest.mark.parametrize("slots,sort_pad,seconds", [
    (1 << 20, 3968, 0.004), (5_000_000, 4_980_736, 0.2), (64, 64, 0.0)])
def test_sort_fraction_is_the_jax_one(jax_provenance, slots, sort_pad, seconds):
    import torch

    ex = types.SimpleNamespace(total_slots=slots, sort_pad=sort_pad,
                               er_all=torch.zeros(1, dtype=torch.int32))
    assert _provenance.sort_fraction(ex, seconds) == jax_provenance.sort_fraction(
        ex, seconds)
