"""``enqueue_ms`` (executor dispatch): host milliseconds from a call's entry
to its return, before the synchronise, over every call of the window (the
slowest rank's a call)."""


def read(rec: dict):
    enq = rec.get("enqueue_s")
    return sum(enq) / len(enq) * 1e3 if enq else None
