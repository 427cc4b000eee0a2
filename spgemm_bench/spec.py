"""Finding a cell's parts by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name, so that a later change adds a cell by
adding files:

* ``configs/<config>.json`` (the path the configuration's ``file`` gives):
  the generator and its sizes;
* ``mixes/<traffic>.json``: data, the op the closed loop calls and its
  parameters; ``ops/<op>.py``: that op, found by its name (``ops`` is the
  one general driver);
* ``e2e/<metric>.py`` with ``compute(rec)``, and ``metrics/<metric>.py``
  with ``read(rec)``: each returns the metric's value from the run's record,
  or ``None`` where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["ROOT", "Cell", "load_cell"]

ROOT = Path(__file__).resolve().parent.parent
HERE = "spgemm_bench"


def _module(path: Path):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"_spgemm_bench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, its mix and
    the metrics it reports."""

    def __init__(self, root: Path, bench: dict, workload: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.root = Path(root)
        self.workload = cells[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = json.loads((self.root / entry["file"]).read_text())
        self.mix = json.loads(
            (self.root / HERE / "mixes" / f"{self.workload['traffic']}.json").read_text())
        self.end_to_end = self._applying(bench["end_to_end"])
        self.per_layer = self._applying(bench["per_layer"])

    def _applying(self, metrics: list) -> list:
        return [m for m in metrics if self.name in m.get("workloads", [self.name])]

    def values(self, rec: dict, trace: bool) -> dict:
        """``{name: {"value", "unit"}}`` of the cell's end-to-end metrics
        (``trace`` false) or per-layer metrics (true); a metric that finds
        nothing to read is left out."""
        kind, fn = ("metrics", "read") if trace else ("e2e", "compute")
        out = {}
        for m in self.per_layer if trace else self.end_to_end:
            value = getattr(_module(self.root / HERE / kind / f"{m['name']}.py"), fn)(rec)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    return Cell(root, bench, workload)
