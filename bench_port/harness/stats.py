"""The arithmetic of the metrics: rates over a window, tails over all
samples, and the union of busy intervals and the gaps between them."""

from __future__ import annotations

import math


def per_item(wall: float, items: int):
    """The window's wall over the items completed in it (None for none)."""
    return wall / items if items else None


def percentile(values, q: float):
    """The q-th percentile (0 < q ≤ 100) of all ``values``, nearest rank:
    the smallest value with at least q % of the values at or below it."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def merge(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(i) for i in out]


def gaps(busy, start: float, end: float) -> list:
    """The idle (start, end) intervals of [start, end] outside ``busy``
    (merged)."""
    out = []
    t = start
    for s, e in busy:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [g for g in out if g[1] > g[0]]
