"""``device_idle_share`` (device): the share of the traced device timeline,
first operation's start to last one's end, that no kernel or copy covers;
the mean over the ranks."""


def read(rec: dict):
    trace = [s for s in rec.get("trace") or () if s["span_s"] > 0]
    if not trace:
        return None
    return sum(1.0 - s["busy_s"] / s["span_s"] for s in trace) / len(trace) * 100.0
