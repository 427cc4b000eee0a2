"""``rank_skew`` (row partition): the slowest rank's device busy time a step
over the mean over the ranks."""


def read(rec: dict):
    trace = rec.get("trace") or []
    if len(trace) < 2:
        return None
    busy = [s["busy_s"] / s["calls"] for s in trace]
    mean = sum(busy) / len(busy)
    return max(busy) / mean if mean > 0 else None
