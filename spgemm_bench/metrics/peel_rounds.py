"""``peel_rounds`` (k-truss peel): the support rounds a traced call of the
k-truss peel runs (the program's ``ktruss.rounds`` count, the last round
that drops nothing included), the mean over the traced calls."""
from spgemm_bench.spans import calls


def read(rec: dict):
    window = calls(rec)
    if not window:
        return None
    rounds = [root.counts.get("ktruss.rounds") for root, _ in window]
    if None in rounds:
        return None
    return sum(rounds) / len(rounds)
