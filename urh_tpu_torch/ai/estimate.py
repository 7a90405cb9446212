"""Center detection for the stream's automatic-center mode.

A copy of urh_tpu.ai.estimate.detect_center and _dominant_local_maxima
(AutoInterpretation.py:226-277 of the reference), host NumPy as urh_tpu
runs them on the host, with np.histogram for its histogram.  The rest of
``estimate`` is still to port (ROADMAP.md queue A, item A8).
"""

from __future__ import annotations

import numpy as np


def detect_center(rectangular_signal: np.ndarray, max_size=None):
    """Mean of the two dominant histogram levels of the rectangular
    signal; edge 5% discarded."""
    rect = rectangular_signal[rectangular_signal > -4]  # noise sentinel
    rect = rect[int(0.05 * len(rect)) : int(0.95 * len(rect))]
    if max_size is not None and len(rect) > max_size:
        rect = rect[:max_size]
    if len(rect) == 0:
        return None

    lo, hi = float(np.min(rect)), float(np.max(rect))
    step = float(np.var(rect))
    try:
        edges = np.arange(lo, hi + step, step)
        counts = (np.histogram(rect, bins=edges)[0] if len(edges) > 1
                  else np.zeros(0, dtype=np.int64))
    except (ZeroDivisionError, ValueError, MemoryError):
        return None  # constant segment: no center to find

    peaks = _dominant_local_maxima(counts, edges, wanted=2)
    return np.mean(peaks) if peaks else None


def _dominant_local_maxima(counts: np.ndarray, edges: np.ndarray,
                           wanted: int) -> list:
    """Bin edges of the strongest strictly-local histogram maxima; a
    maximum must dominate a window of ~5% of the bins on both sides."""
    reach = max(2, int(0.05 * len(counts)) + 1)
    found = []
    for index in np.argsort(counts)[::-1]:
        value = counts[index]
        if value <= 0:  # an empty bin can never dominate its window
            continue
        left = counts[max(0, index - reach + 1) : index]
        right = counts[index + 1 : index + reach]
        if (value > left).all() and (value > right).all():
            found.append(edges[index])
        if len(found) == wanted:
            break
    return found
