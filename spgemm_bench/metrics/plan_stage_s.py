"""``plan_stage_s`` (planner and staging): host seconds in the program's
``plan.stage`` spans of set-up: the host fill of the staged arrays (ELL
tables and entries, ESC's padded chunks, a staged mask) and their uploads."""
from spgemm_bench.spans import seconds_in


def read(rec: dict):
    return seconds_in("plan.stage")
