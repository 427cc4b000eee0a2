"""``syncs_per_call`` (executor dispatch): the device reads a traced call
makes (its outermost ``sync.*`` spans), the mean over the traced calls."""
from spgemm_bench.spans import calls, outermost


def read(rec: dict):
    window = calls(rec)
    if not window:
        return None
    return sum(len(outermost(inner, "sync.")) for _, inner in window) / len(window)
