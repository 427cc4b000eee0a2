"""``plan_search_s`` (planner and staging): host seconds in the program's
``plan.search`` spans of set-up, the outermost ones: the blocked screen,
``row_flops``, the batched planner's bin-count search, the chunking."""
from spgemm_bench.spans import seconds_in


def read(rec: dict):
    return seconds_in("plan.search")
