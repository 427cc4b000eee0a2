"""Kernel names to layers.  Each per-layer metric that sums device time
keeps its own ``PATTERNS`` (regular expressions searched in the profiler's
operation names) in its own file under ``metrics/``; this module applies
them to one rank's traced window (``timeline.summarize``)."""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

__all__ = ["device_seconds", "patterns_of", "per_call"]

METRICS = Path(__file__).resolve().parent / "metrics"


def device_seconds(summary: dict, patterns) -> float | None:
    """Seconds of the device operations whose names match any pattern, or
    ``None`` where none matches."""
    rx = [re.compile(p) for p in patterns]
    hits = [sec for name, sec in summary["by_name"].items()
            if any(r.search(name) for r in rx)]
    return sum(hits) if hits else None


def per_call(rec: dict, patterns) -> float | None:
    """Milliseconds a call of the matching operations on the slowest rank,
    or ``None`` where no rank ran one."""
    trace = rec.get("trace")
    if not trace:
        return None
    vals = [device_seconds(s, patterns) for s in trace]
    vals = [v / s["calls"] * 1e3 for v, s in zip(vals, trace) if v is not None]
    return max(vals) if vals else None


def patterns_of(metric: str, where: Path = METRICS) -> list[str]:
    """The ``PATTERNS`` of ``metrics/<metric>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"_patterns_{metric}", where / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return list(mod.PATTERNS)
