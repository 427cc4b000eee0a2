"""``plan_tables_s`` (planner and staging): host seconds in the program's
``plan.tables`` spans of set-up: B's sliced-ELL tables (``EllB.build``) and
the partition of A's entries by class (``_build_class_entries``)."""
from spgemm_bench.spans import seconds_in


def read(rec: dict):
    return seconds_in("plan.tables")
