"""``step_roofline`` (kernels as a whole): the least time the product's
bytes need (A read once, C's indices and row pointers written once; see
``roofline.py``) over the chips' HBM rate, as a share of the device busy
time a call (the mean over the ranks)."""
from spgemm_bench.peaks import HBM_BYTES_PER_S


def read(rec: dict):
    trace = rec.get("trace")
    need = rec.get("bytes_needed")
    if not trace or not need:
        return None
    busy = sum(s["busy_s"] / s["calls"] for s in trace) / len(trace)
    if busy <= 0:
        return None
    return need / (HBM_BYTES_PER_S * rec["chips"]) / busy * 100.0
