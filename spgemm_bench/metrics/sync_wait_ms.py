"""``sync_wait_ms`` (executor dispatch): host milliseconds a traced call in
its device reads (``sync.*`` spans: a ``.cpu()`` or ``int()`` of a device
tensor, which waits for the work queued before it), the mean over the traced
calls; 0 where a call reads nothing back."""
from spgemm_bench.spans import NS, calls, outermost


def read(rec: dict):
    window = calls(rec)
    if not window:
        return None
    waits = [sum(s.t1 - s.t0 for s in outermost(inner, "sync.")) for _, inner in window]
    return sum(waits) / len(waits) * NS * 1e3
