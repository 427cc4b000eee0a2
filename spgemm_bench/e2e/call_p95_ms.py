"""``call_p95_ms``: the 95th percentile of every call's latency in the
window (host clock from the call to the synchronise that makes its result
usable; the slowest rank's on several cards)."""
from spgemm_bench.latency import percentile


def compute(rec: dict):
    return percentile(rec["latency_s"], 95) * 1e3
