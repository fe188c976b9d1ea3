"""The benchmark's arithmetic on host-clock readings: rates over the
window and the idle share of a device from its operations' intervals."""
from __future__ import annotations

import numpy as np


def rate(done_counts, done_times, t0: float, t_end: float) -> float:
    """Work per second over the window [t0, t_end]: the units of every
    step that completed inside it, over the window's whole length (a step
    that straddles the close is not counted, and a stall before the close
    lowers the rate)."""
    c = np.asarray(done_counts, np.float64)
    t = np.asarray(done_times, np.float64)
    return float(c[t <= t_end].sum() / (t_end - t0))


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi]."""
    iv = sorted((max(a, lo), min(b, hi)) for a, b in intervals
                if b > lo and a < hi)
    total = 0.0
    cur_a = cur_b = None
    for a, b in iv:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no interval covers -> [(start,
    end)], longest first."""
    iv = sorted((max(a, lo), min(b, hi)) for a, b in intervals
                if b > lo and a < hi)
    gaps = []
    cur = lo
    for a, b in iv:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])
