"""Call latencies: the slowest rank's wall for each call, and the tail.

A call on several ranks is done when its slowest rank is; each rank keeps
its own list of walls in call order, and the lists are gathered after the
window.
"""
from __future__ import annotations

import math

__all__ = ["percentile", "slowest_rank"]


def slowest_rank(per_rank: list[list[float]]) -> list[float]:
    """Call i's latency: the largest of the ranks' walls for call i.  Every
    rank must have made the same calls."""
    if len({len(walls) for walls in per_rank}) != 1:
        raise ValueError("ranks report different numbers of calls")
    return [max(walls) for walls in zip(*per_rank)]


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at least
    ``q`` % of all values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100.0 * len(ordered)), 1) - 1]
