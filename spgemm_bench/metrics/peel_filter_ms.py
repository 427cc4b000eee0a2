"""``peel_filter_ms`` (k-truss peel): host milliseconds a traced call in
the peel's filter steps (the program's ``ktruss.filter`` spans: the entries
below the support bound dropped, the next round's widths counted), summed
over the call's rounds, the mean over the traced calls."""
from spgemm_bench.spans import NS, calls


def read(rec: dict):
    window = calls(rec)
    if not window:
        return None
    per_call = [sum(s.t1 - s.t0 for s in inner if s.name == "ktruss.filter")
                for _, inner in window]
    if not any(any(s.name == "ktruss.filter" for s in inner) for _, inner in window):
        return None
    return sum(per_call) / len(per_call) * NS * 1e3
