"""Window arithmetic: rates over all the work and all the time of a
window, percentiles over every call, and the device's busy and idle time
from its operation intervals."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple


def rate(units: Sequence[float], t_start: float, t_end: float) -> float:
    """All the work completed in the window over the window's length."""
    return float(sum(units)) / (t_end - t_start)


def percentile(values: Sequence[float], q: int) -> float:
    """The q-th percentile of every value (``statistics.quantiles`` with
    100 cuts, inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100, method="inclusive")[q - 1])


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union of (start, end) intervals, sorted and disjoint."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals: Iterable[Tuple[float, float]]) -> float:
    """Time covered by at least one interval."""
    return sum(e - s for s, e in merge(intervals))


def gaps(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle stretches between merged intervals."""
    m = merge(intervals)
    return [(a[1], b[0]) for a, b in zip(m, m[1:]) if b[0] > a[1]]


def idle_share(busy_s: float, window_s: float) -> float:
    return 1.0 - busy_s / window_s
