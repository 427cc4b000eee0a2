"""``peel_round_ms`` (k-truss peel): host milliseconds of a round of the
peel (the program's ``ktruss.round`` spans, each closed by its round's
device read, so each holds the round's device work), the mean over every
round of the traced calls."""
from spgemm_bench.spans import NS, calls


def read(rec: dict):
    window = calls(rec)
    if not window:
        return None
    rounds = [s.t1 - s.t0 for _, inner in window for s in inner if s.name == "ktruss.round"]
    return sum(rounds) / len(rounds) * NS * 1e3 if rounds else None
