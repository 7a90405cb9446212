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
    (auto_interpretation.pyx:179-208).  One message of
    :func:`plateau_lengths_of_spans`."""
    rect_data = np.asarray(rect_data)
    if center is None:
        return np.array([], dtype=np.uint64)
    return plateau_lengths_of_spans(rect_data, [(0, len(rect_data))], [center], percentage)[0]


def plateau_lengths_of_spans(rect: np.ndarray, spans: list, centers: list,
                             percentage: int = 25) -> list:
    """get_plateau_lengths of each span ``rect[start:end]`` at its own center,
    in one pass over the spans laid end to end: each sample is compared with
    its span's center as get_plateau_lengths compares it, every span starts
    a run, a span's last (still open) run is never appended, and a span's
    runs stop at the first whose cumulative length reaches ``percentage`` of
    the span."""
    lengths = np.array([end - start for start, end in spans], dtype=np.int64)
    starts = np.zeros(len(spans) + 1, dtype=np.int64)
    np.cumsum(lengths, out=starts[1:])
    total = int(starts[-1])
    if total == 0:
        return [np.array([], dtype=np.uint64) for _ in spans]

    above = np.empty(total, dtype=bool)
    for (start, end), center, at in zip(spans, centers, starts):
        _greater(rect[start:end], center, above[at:at + end - start])
    first = np.empty(total, dtype=bool)  # a run starts here
    first[0] = True
    np.not_equal(above[1:], above[:-1], out=first[1:])
    first[starts[:-1][lengths > 0]] = True
    bounds = np.flatnonzero(first)
    ends = np.append(bounds[1:], total)
    span = np.searchsorted(starts[1:], bounds, side="right")
    # only complete runs get appended (each span's final, open run never is)
    appended = ends != starts[1:][span]
    runs, span = (ends - bounds)[appended], span[appended]

    count = np.bincount(span, minlength=len(spans))
    first_run = np.zeros(len(spans) + 1, dtype=np.int64)
    np.cumsum(count, out=first_run[1:])
    cum = np.cumsum(runs)
    cum -= np.concatenate(([0], cum))[first_run[:-1]][span]  # within the span
    limit = percentage * lengths // 100
    reached = np.flatnonzero(cum >= limit[span])
    cut = first_run[1:].copy()  # end of each span's kept runs
    if len(reached):
        spans_reached = span[reached]
        first_reached = np.flatnonzero(np.diff(spans_reached, prepend=-1))
        cut[spans_reached[first_reached]] = reached[first_reached] + 1
    runs = runs.astype(np.uint64)
    return [runs[a:z] for a, z in zip(first_run[:-1], cut)]


def _greater(values: np.ndarray, center, out: np.ndarray):
    """np.greater(values, center, out=out).  Where NumPy compares float32
    values with the center in float64, the comparison runs in float32 with
    the greatest float32 at or below the center: a float32 exceeds the center
    exactly when it exceeds that one."""
    if values.dtype == np.float32 and np.result_type(values, center) == np.float64:
        below = np.float32(center)
        if below > center:
            below = np.nextafter(below, np.float32(-np.inf))
        center = below
    np.greater(values, center, out=out)


def merge_plateaus(plateaus: np.ndarray, tolerance: int, max_count: int) -> np.ndarray:
    """Merge glitch plateaus (<= tolerance) into their neighbours
    (auto_interpretation.pyx:145-176), stepping over Python ints."""
    plateaus = np.asarray(plateaus, dtype=np.uint64).tolist()
    L = len(plateaus)
    if L == 0:
        return np.zeros(0, dtype=np.uint64)

    result = [0] * L
    result[0] = 0 if plateaus[0] <= tolerance else plateaus[0]
    current = 0
    i = 1
    while i < L and current < max_count:
        if plateaus[i] <= tolerance:
            # look ahead for an alternating glitch window, e.g. 67, 1, 10, 1, 21
            n = 2
            while i + n < L and plateaus[i + n] <= tolerance:
                n += 2
            result[current] = sum(plateaus[i - 1 : min(L, i + n)])
            i += n
        else:
            current += 1
            result[current] = plateaus[i]
            i += 1
    return np.array(result[: current + 1], dtype=np.uint64)


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
    if unique[0] == 0:
        unique, counts = unique[1:], counts[1:]
    if len(unique) == 0:
        return histogram

    # unique is sorted, so in a distinct pair i < j min = unique[i], max =
    # unique[j]; identical pairs have ratio exactly 1, always below threshold
    u = unique.astype(np.float64)
    frac = u[None, :] / u[:, None] - (unique[None, :] // unique[:, None]).astype(np.float64)
    hit = np.triu(frac < threshold, 1)
    pairs = (hit * counts[None, :]).sum(axis=1) * counts
    histogram[unique.astype(np.int64)] = (counts * (counts - 1) // 2 + pairs).astype(np.uint64)
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
