"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, by linear
    interpolation between the two nearest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(units: Iterable[float], start: float, end: float) -> float:
    """Work a second over the whole window: every unit completed, over the
    time from the window's start to the end of the last unit."""
    return sum(units) / (end - start)


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """The length of the union of intervals (start, end)."""
    return sum(e - s for s, e in merge(intervals))


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as disjoint intervals, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]
