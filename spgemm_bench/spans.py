"""Reading the program's own spans and counts (the recorder of
``binary_spgemm_tpu_torch.utils.trace``) in the process that ran the cell.

The planner's ``plan.*`` spans record in set-up with no profiler running;
every other span records only inside the traced window, whose calls are the
last ``calls`` root ``call.*`` spans (the harness makes no program call under
the profiler after them).  Each reader returns ``None`` where the program
has no recorder (a checkout without it), where the recorder dropped spans,
or where it finds nothing to read.
"""
from __future__ import annotations

__all__ = ["NS", "calls", "outermost", "recorded", "seconds_in"]

NS = 1e-9  # span times are in nanoseconds


def recorded() -> list | None:
    """Every span the program recorded in this process, or ``None``."""
    try:
        from binary_spgemm_tpu_torch.utils import trace
    except ImportError:
        return None
    read = getattr(trace, "spans", None)
    if read is None or getattr(trace, "dropped", 0):
        return None
    return read()


def outermost(spans: list, prefix: str) -> list:
    """The spans whose name starts with ``prefix`` and that no span of such a
    name encloses."""
    by_id = {s.id: s for s in spans}

    def inside(s) -> bool:
        p = by_id.get(s.parent)
        while p is not None:
            if p.name.startswith(prefix):
                return True
            p = by_id.get(p.parent)
        return False

    return [s for s in spans if s.name.startswith(prefix) and not inside(s)]


def seconds_in(name: str) -> float | None:
    """Host seconds in the outermost spans named ``name`` (the planner's
    spans of set-up), or ``None`` where there are none."""
    spans = recorded()
    hits = outermost(spans, name) if spans else []
    hits = [s for s in hits if s.name == name]
    return sum(s.t1 - s.t0 for s in hits) * NS if hits else None


def calls(rec: dict) -> list | None:
    """The traced window's calls, each ``(root, descendants)``: the last
    ``rec["trace"][0]["calls"]`` root ``call.*`` spans, with every span that
    shares its call id; ``None`` where the window recorded fewer."""
    trace, spans = rec.get("trace"), recorded()
    if not trace or not spans:
        return None
    n = trace[0]["calls"]
    roots = sorted((s for s in spans if s.parent is None and s.name.startswith("call.")),
                   key=lambda s: s.t0)[-n:]
    if n < 1 or len(roots) < n:
        return None
    inner = {r.id: [] for r in roots}
    for s in spans:
        if s.call in inner and s.id != s.call:
            inner[s.call].append(s)
    return [(r, inner[r.id]) for r in roots]
