"""Interval arithmetic the metrics share, and the spread of runs."""
from __future__ import annotations

import statistics
from typing import Iterable, Sequence


def union(intervals: Iterable[tuple], lo: float, hi: float) -> list:
    """The union of ``(start, end)`` intervals clipped to [lo, hi], merged
    and in order."""
    merged = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def covered(intervals: Iterable[tuple], lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that some interval covers."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals: Iterable[tuple], lo: float, hi: float) -> list:
    """The parts of [lo, hi] that no interval covers, in order."""
    out, cursor = [], lo
    for s, e in union(intervals, lo, hi):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < hi:
        out.append((cursor, hi))
    return out


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles over the median
    (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
