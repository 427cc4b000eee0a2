"""``flop_rate``: Gustavson flops of every call completed in the window, over
the window's seconds (the whole product's flops, also on several cards)."""


def compute(rec: dict):
    return rec["flops"] * rec["calls"] / rec["window_s"] / 1e9
