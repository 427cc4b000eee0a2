"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated`` from the start of
set-up through the window, the highest rank's on several cards."""


def compute(rec: dict):
    peak = rec.get("peak_bytes")
    return None if peak is None else peak / 2**30
