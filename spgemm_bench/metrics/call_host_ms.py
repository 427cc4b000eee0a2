"""``call_host_ms`` (executor dispatch): host milliseconds of a traced call's
root ``call.*`` span less its ``sync.*`` spans (the waits for the device),
the mean over the traced calls."""
from spgemm_bench.spans import NS, calls, outermost


def read(rec: dict):
    window = calls(rec)
    if not window:
        return None
    host = [(root.t1 - root.t0) - sum(s.t1 - s.t0 for s in outermost(inner, "sync."))
            for root, inner in window]
    return sum(host) / len(host) * NS * 1e3
