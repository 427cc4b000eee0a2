"""``input_check_ms`` (executor dispatch): host milliseconds a traced call in
its input checks (``call.check``: the int32 domain, ``sum_duplicates``'
canonical check), the mean over the traced calls."""
from spgemm_bench.spans import NS, calls, outermost


def read(rec: dict):
    window = calls(rec)
    if not window:
        return None
    checks = [outermost(inner, "call.check") for _, inner in window]
    if not any(checks):
        return None
    return sum(s.t1 - s.t0 for c in checks for s in c) / len(window) * NS * 1e3
