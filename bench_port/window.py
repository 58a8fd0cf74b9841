"""Window arithmetic of the benchmark: pure functions over host-clock and
trace timestamps, kept apart so the CPU tests can hold them to hand-worked
cases."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values``, linear between closest
    ranks (numpy's default), over every value given."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) ``intervals`` clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """(start, end) of every stretch of [lo, hi] that no interval covers,
    longest first."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])
