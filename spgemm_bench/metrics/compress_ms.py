"""``compress_ms`` (expansion and compress in torch ops): the device
milliseconds a call that are none of the sorts, gathers or collectives
(their metrics' own patterns): expansion, keys, dedup, scans, copies.  The
slowest rank's."""
import re
from pathlib import Path

from spgemm_bench.classify import patterns_of


def read(rec: dict):
    trace = rec.get("trace")
    if not trace:
        return None
    rx = [re.compile(p) for m in ("sort_ms", "gather_ms", "collective_ms")
          for p in patterns_of(m, Path(__file__).resolve().parent)]
    vals = [sum(sec for name, sec in s["by_name"].items()
                if not any(r.search(name) for r in rx)) / s["calls"] * 1e3
            for s in trace]
    return max(vals) if any(vals) else None
