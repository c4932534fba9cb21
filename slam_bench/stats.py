"""The benchmark's arithmetic: tails over all samples, spreads, device
timelines (the union of spans, the idle gaps between them)."""

from __future__ import annotations

import math
import statistics


def percentile(xs, q: float) -> float | None:
    """The nearest-rank ``q`` quantile (0 < q <= 1) of all of ``xs``: the
    smallest value with at least q of the samples at or below it."""
    xs = sorted(xs)
    if not xs:
        return None
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def spread(xs) -> float:
    """The distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(xs, n=4)``)."""
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return (q3 - q1) / med


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and merged."""
    out: list[list[float]] = []
    for a, b in sorted((a, b) for a, b in intervals if b > a):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals) -> float:
    """The length the union of ``intervals`` covers."""
    return sum(b - a for a, b in union(intervals))


def gaps(intervals, start: float, end: float) -> list[tuple[float, float]]:
    """The stretches of [start, end] that no interval covers, longest first."""
    out, t = [], start
    for a, b in union(intervals):
        a, b = max(a, start), min(b, end)
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if end > t:
        out.append((t, end))
    return sorted(out, key=lambda g: g[0] - g[1])
