"""``gather_ms`` (class-table gathers): device milliseconds a call in P3 and
P4 (``class_gather*``).  The slowest rank's."""
from spgemm_bench.classify import per_call

PATTERNS = [r"class_gather"]


def read(rec: dict):
    return per_call(rec, PATTERNS)
