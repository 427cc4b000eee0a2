"""``launches_per_call`` (executor dispatch): device kernels, copies and sets
the profiler recorded a call, the mean over the ranks."""


def read(rec: dict):
    trace = rec.get("trace")
    if not trace or not any(s["device_ops"] for s in trace):
        return None
    return sum(s["device_ops"] / s["calls"] for s in trace) / len(trace)
