"""``plan_s`` (planner and staging): host seconds around the construction of
the executor or the distributed step (the slowest rank's)."""


def read(rec: dict):
    return rec.get("plan_s")
