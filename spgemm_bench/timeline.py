"""Reading a ``torch.profiler`` trace: the device timeline and what the host
did while the device sat idle.

:func:`summarize` reduces one rank's profiler events to a small record the
per-layer metrics read: device time by operation name, the union of device
operations (busy), the span from the first device operation's start to the
last one's end, and the idle gaps, each named by the innermost host
operation that was running at its midpoint.  The arithmetic is
``chip_smoke.py::profile_run``'s, copied so the yardstick stays here.
"""
from __future__ import annotations

import bisect

__all__ = ["busy_and_gaps", "name_gaps", "summarize", "top"]

US = 1e-6  # profiler times are in microseconds


def busy_and_gaps(spans):
    """``(busy, span, gaps)`` of device intervals ``[(start, end), ...]``:
    the length of their union, the first start to the last end, and the
    uncovered intervals in between."""
    spans = sorted(spans)
    if not spans:
        return 0.0, 0.0, []
    busy, gaps = 0.0, []
    reach = spans[0][0]
    for t0, t1 in spans:
        if t0 > reach:
            gaps.append((reach, t0))
        busy += max(0.0, t1 - max(t0, reach))
        reach = max(reach, t1)
    return busy, reach - spans[0][0], gaps


def name_gaps(gaps, host_ops, scan: int = 4096) -> dict:
    """Total gap length by the innermost host operation ``(start, end,
    name)`` running at each gap's midpoint (``"host idle"`` where none)."""
    host_ops = sorted(host_ops)
    starts = [op[0] for op in host_ops]
    out: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        name = "host idle"
        i = bisect.bisect_right(starts, mid) - 1
        # the latest-starting op that still covers mid is the innermost
        for j in range(i, max(i - scan, -1), -1):
            if host_ops[j][1] >= mid:
                name = host_ops[j][2]
                break
        out[name] = out.get(name, 0.0) + (g1 - g0)
    return out


def summarize(events, *, calls: int, wall_s: float) -> dict:
    """One rank's traced window from profiler events, each ``(is_device,
    start_us, end_us, name)``: seconds by device operation name, busy and
    span seconds, device operations counted, idle gaps by host operation."""
    dev, host = [], []
    for is_device, t0, t1, name in events:
        if t1 <= t0:
            continue
        (dev if is_device else host).append((t0, t1, name))
    by_name: dict[str, float] = {}
    for t0, t1, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) * US
    busy, span, gaps = busy_and_gaps([(t0, t1) for t0, t1, _ in dev])
    return {
        "calls": calls,
        "wall_s": wall_s,
        "busy_s": busy * US,
        "span_s": span * US,
        "device_ops": len(dev),
        "by_name": by_name,
        "gaps": {k: v * US for k, v in name_gaps(gaps, host).items()},
    }


def top(d: dict, k: int = 10) -> list:
    """The ``k`` largest entries of ``{name: seconds}`` as ``[[name, seconds]]``."""
    return [[name, sec] for name, sec in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
