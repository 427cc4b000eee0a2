"""``sort_slots_per_flop`` (row sorts): the slots a traced call hands to its
row sorts (the program's ``sort.slots`` count: K1 through ``sort_rows`` and
every ``torch.sort``, from the tensors' shapes), the mean over the traced
calls, over the call's Gustavson flops."""
from spgemm_bench.spans import calls


def read(rec: dict):
    window = calls(rec)
    flops = rec.get("flops")
    if not window or not flops:
        return None
    slots = [root.counts.get("sort.slots") for root, _ in window]
    if None in slots:
        return None
    return sum(slots) / len(slots) / flops
