"""The band-pass filter's least time: the bytes the work must move at the
card's peak bandwidth, whatever implements the filter.  The capture's own
samples are read once (two components of the sample's dtype) and the
filtered signal's float32 planes written once (8 bytes a sample)."""

from __future__ import annotations

from benchmark import yardstick

PLANE_BYTES = 2 * 4


def least_bytes(n_samples: int, sample_itemsize: int) -> int:
    return int(n_samples) * (2 * int(sample_itemsize) + PLANE_BYTES)


def least_seconds(n_samples: int, sample_itemsize: int) -> float:
    return yardstick.least_seconds(least_bytes(n_samples, sample_itemsize))
