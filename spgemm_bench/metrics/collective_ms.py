"""``collective_ms`` (collectives): device milliseconds a step in NCCL's
kernels, the slowest rank's."""
from spgemm_bench.classify import per_call

PATTERNS = [r"nccl"]


def read(rec: dict):
    return per_call(rec, PATTERNS)
