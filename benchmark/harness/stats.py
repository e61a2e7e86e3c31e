"""The arithmetic of the end-to-end metrics and of the device's busy
time."""
from __future__ import annotations

import statistics


def rate(count: float, seconds: float) -> float:
    """Work completed over all the time of the window."""
    return count / seconds


def p90(values) -> float:
    """90th percentile of every value (inclusive quantiles, as
    ``statistics.quantiles`` gives them)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=10, method="inclusive")[-1])


def union_length(intervals, lo=None, hi=None) -> float:
    """Length of the union of (start, end) intervals, clipped to
    [lo, hi] where given: the device's busy time from its kernel and
    copy intervals (overlapping launches count once)."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b <= a:
            continue
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def gaps(intervals, lo, hi):
    """The idle gaps (start, end) between the union of ``intervals``
    inside [lo, hi]."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if b <= cur:
            continue
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]

