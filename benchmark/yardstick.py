"""The benchmark's fixed arithmetic: the card's peak, the least bytes a
demodulation must move, the union of device activity, and percentiles.

A kernel's share of its roofline is its least time, the bytes the work must
move at the card's peak bandwidth, over the device time it took.  The least
bytes follow ``chip_smoke.py``'s bound: each input byte read once and each
output written once.  For a demodulation that is the capture's samples (two
components of the sample's dtype) and one state of one byte a sample.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12
STATE_BYTES = 1


def demod_least_bytes(n_samples: int, sample_itemsize: int) -> int:
    return int(n_samples) * (2 * int(sample_itemsize) + STATE_BYTES)


def least_seconds(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S


def union_seconds(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(intervals, lo: float, hi: float) -> list:
    """[(start, end)] of [lo, hi] not covered by the intervals."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def percentile(values, q: float) -> float:
    """The q-th percentile of all values, by linear interpolation between
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
