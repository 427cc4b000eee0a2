"""``comm_mb_per_step`` (collectives): the bytes every rank's collectives
sent in the window (``parallel.comm.counters["bytes"]``), summed over the
ranks, a step, in MB (10^6 bytes)."""


def read(rec: dict):
    sent = rec.get("comm_bytes")
    return sent / rec["calls"] / 1e6 if sent else None
