"""Auto-interpretation primitive kernels (PyTorch port of urh_tpu.ai.kernels).

Equivalents of urh/cythonext/auto_interpretation.pyx:

* ``median_filter`` — forward-window median (the reference's window starts
  AT i, not centered), through the B7 kernel
  (:mod:`urh_tpu_torch.ai.median_kernels`) on the given device;
* ``get_plateau_lengths``, ``merge_plateaus``,
  ``get_threshold_divisor_histogram`` and ``k_means`` — host NumPy copies,
  as urh_tpu runs them on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from urh_tpu_torch.ai.median_kernels import median_filter as _median_rows
from urh_tpu_torch.core.iq import resolve_device


def median_filter(data: np.ndarray, k: int = 3, device=None) -> np.ndarray:
    """Forward-window median: out[i] = median(data[i:i+k])
    (auto_interpretation.pyx:211-240; the window is [i, i+k), shrunk at the
    array end, and the middle index uses the shrunk window size).  The
    values are rounded to float32 first: rounding keeps their order, so the
    median is the float32 of urh_tpu's float64 one."""
    x = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
    if len(x) == 0:
        return np.zeros(0, dtype=np.float32)
    return _median_rows(x.to(resolve_device(device)), k).cpu().numpy()


def get_plateau_lengths(rect_data: np.ndarray, center: float, percentage: int = 25) -> np.ndarray:
    """Run lengths of (sample <= center) polarity until the cumulative
    appended length reaches ``percentage`` of the data
    (auto_interpretation.pyx:179-208)."""
    rect_data = np.asarray(rect_data)
    n = len(rect_data)
    if n == 0 or center is None:
        return np.array([], dtype=np.uint64)

    above = rect_data > center
    change = np.flatnonzero(above[1:] != above[:-1]) + 1
    bounds = np.concatenate(([0], change, [n]))
    runs = np.diff(bounds).astype(np.uint64)

    # only complete runs get appended (the final, still-open run never is)
    appended = runs[:-1]
    if len(appended) == 0:
        return np.array([], dtype=np.uint64)

    limit = percentage * n // 100
    cum = np.cumsum(appended)
    reached = np.flatnonzero(cum >= limit)
    if len(reached):
        return appended[: reached[0] + 1]
    return appended


def merge_plateaus(plateaus: np.ndarray, tolerance: int, max_count: int) -> np.ndarray:
    """Merge glitch plateaus (<= tolerance) into their neighbours
    (auto_interpretation.pyx:145-176)."""
    plateaus = np.asarray(plateaus, dtype=np.uint64)
    L = len(plateaus)
    if L == 0:
        return np.zeros(0, dtype=np.uint64)

    result = np.empty(L, dtype=np.uint64)
    result[0] = 0 if plateaus[0] <= tolerance else plateaus[0]
    current = 0
    i = 1
    while i < L and current < max_count:
        if plateaus[i] <= tolerance:
            # look ahead for an alternating glitch window, e.g. 67, 1, 10, 1, 21
            n = 2
            while i + n < L and plateaus[i + n] <= tolerance:
                n += 2
            result[current] = plateaus[i - 1 : min(L, i + n)].sum()
            i += n
        else:
            current += 1
            result[current] = plateaus[i]
            i += 1
    return result[: current + 1]


def get_threshold_divisor_histogram(plateau_lengths: np.ndarray, threshold: float = 0.2) -> np.ndarray:
    """Histogram of how often a value is an approximate divisor of the
    others (auto_interpretation.pyx:113-143): for every unordered pair,
    count min(x, y) if max/min has fractional part < threshold."""
    p = np.asarray(plateau_lengths, dtype=np.uint64)
    if len(p) == 0:
        return np.zeros(1, dtype=np.uint64)
    histogram = np.zeros(int(p.max()) + 1, dtype=np.uint64)

    # The histogram value only depends on the pair's VALUES, so collapse to
    # unique values with multiplicities: O(U^2) instead of O(L^2).
    unique, counts = np.unique(p, return_counts=True)
    nz = unique != 0
    unique, counts = unique[nz], counts[nz]
    if len(unique) == 0:
        return histogram

    # identical pairs: ratio exactly 1 -> always below threshold
    histogram[unique.astype(np.int64)] += (counts * (counts - 1) // 2).astype(np.uint64)

    # distinct pairs: unique is sorted, so min = unique[i], max = unique[j], i<j
    u = unique.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = u[None, :] / u[:, None] - (unique[None, :] // unique[:, None]).astype(np.float64)
    iu = np.triu_indices(len(unique), k=1)
    hit = frac[iu] < threshold
    pair_counts = (counts[iu[0]] * counts[iu[1]])[hit]
    np.add.at(histogram, unique[iu[0]][hit].astype(np.int64), pair_counts.astype(np.uint64))
    return histogram


def k_means(data: np.ndarray, k: int = 2):
    """1-D k-means with the reference's init (arbitrary unique values) and
    convergence criterion (auto_interpretation.pyx:13-52)."""
    data = np.asarray(data, dtype=np.float32)
    unique = set(float(x) for x in data)
    if len(unique) < k:
        k = len(unique)

    centers = np.empty(k, dtype=np.float32)
    for i in range(k):
        centers[i] = unique.pop()

    clusters = [[] for _ in range(k)]
    error = 1.0
    while error != 0:
        dists = (centers[None, :] - data[:, None]) ** 2
        assign = np.argmin(dists, axis=1)
        old_centers = centers.copy()
        clusters = [data[assign == i] for i in range(k)]
        for i in range(k):
            centers[i] = np.mean(clusters[i]) if len(clusters[i]) else old_centers[i]
        error = float(np.sum(old_centers * old_centers - centers * centers))
    return centers, [list(c) for c in clusters]
