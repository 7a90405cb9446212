"""Noise-floor estimation and power-gate message segmentation (host copy
of urh_tpu.ai.segmentation).

Equivalents of urh/ainterpretation/AutoInterpretation.py:60-148 and the
3-state hysteresis machine urh/cythonext/auto_interpretation.pyx:55-111,
host NumPy as urh_tpu runs them.

The hysteresis segmentation is reformulated run-level (like the
symbolizer in urh_tpu_torch.dsp.symbols): the machine changes state at the
10th consecutive sample of the opposite polarity, so transitions are
exactly the consecutively-deduplicated sequence of above/below runs of
length >= 10, and boundaries fall at ``run_start - 1``.
"""

from __future__ import annotations

import math

import numpy as np

OUTLIER_TOLERANCE = 10  # auto_interpretation.pyx:72


def _drop_outliers(data: np.ndarray, z: float) -> np.ndarray:
    data = np.asarray(data)
    return data[np.abs(data - data.mean()) <= z * data.std()]


def max_without_outliers(data: np.ndarray, z=3):
    return np.max(_drop_outliers(data, z)) if len(data) else None


def min_without_outliers(data: np.ndarray, z=2):
    return np.min(_drop_outliers(data, z)) if len(data) else None


def detect_noise_level(magnitudes: np.ndarray) -> float:
    """Noise floor from 1%-chunk means (semantics of
    AutoInterpretation.py:60-91), as one reshape instead of a chunk loop:
    the capture's trailing full 1%-chunks become rows of a matrix, the
    quietest rows (mean within 10% of the global minimum) vote, and the
    floor is the loudest sample inside any voting row, ceiled to 1e-4."""
    n = len(magnitudes)
    if n <= 3:
        return 0

    chunk = max(1, n // 100)
    rows = np.asarray(magnitudes[n % chunk:], dtype=np.float32)
    rows = rows.reshape(-1, chunk)
    if rows.size == 0:
        return 0

    means = rows.mean(axis=1, dtype=np.float32)
    lo, hi = float(means.min()), float(means.max())
    if hi == 0 or lo / hi > 0.9:
        # chunk means are close together -> probably no noise present
        return 0

    quiet = rows[means <= 1.1 * lo]
    if quiet.size == 0:
        return 0
    return math.ceil(float(quiet.max()) * 10000) / 10000


def segment_messages_from_magnitudes(magnitudes: np.ndarray, noise_threshold: float) -> list:
    """[(start, end), ...] message ranges (auto_interpretation.pyx:55-111)."""
    n = len(magnitudes)
    if n == 0:
        return []

    above = np.asarray(magnitudes) > noise_threshold
    state = 1 if above[0] else -1

    # run-length encode the above/below sequence
    change = np.flatnonzero(above[1:] != above[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [n]))
    lens = ends - starts
    polarity = np.where(above[starts], 1, -1)

    long_mask = lens >= OUTLIER_TOLERANCE
    l_pol = polarity[long_mask]
    l_starts = starts[long_mask]

    # dedup consecutive polarities; drop leading group equal to initial state
    if len(l_pol):
        keep = np.ones(len(l_pol), dtype=bool)
        keep[1:] = l_pol[1:] != l_pol[:-1]
        l_pol = l_pol[keep]
        l_starts = l_starts[keep]
        if l_pol[0] == state:
            l_pol = l_pol[1:]
            l_starts = l_starts[1:]

    result = []
    cur_start = 0
    cur_state = state
    for pol, rs in zip(l_pol, l_starts):
        if cur_state == 1:
            # 1 -> -1 at the 10th below sample: end = run_start - 1
            result.append((cur_start, rs - 1))
            cur_state = -1
        else:
            # -1 -> 1: start = run_start - 1
            cur_start = rs - 1
            cur_state = 1

    if cur_state == 1:
        # trailing below-run (shorter than tolerance, else we'd have flipped)
        conseq_below = int(lens[-1]) if polarity[-1] == -1 else 0
        if cur_start < n - conseq_below:
            result.append((cur_start, n - conseq_below))

    return result


def merge_message_segments_for_ook(segments: list) -> list:
    """Merge OOK pulse groups separated by short pauses
    (AutoInterpretation.py:107-148)."""
    if len(segments) <= 1:
        return segments

    bounds = np.asarray(segments, dtype=np.int64)  # (n, 2) start/end pairs
    pulses = bounds[:, 1] - bounds[:, 0]
    pauses = bounds[1:, 0] - bounds[:-1, 1]

    # a pause >= 8x the typical pulse separates two messages; anything
    # shorter is the gap between OOK pulses of one message
    cut_after = np.flatnonzero(pauses >= 8 * min_without_outliers(pulses, z=1))

    # each group of segments collapses to (first start, last end) — the
    # reference's pulse+pause length accumulation telescopes to exactly that
    firsts = np.concatenate(([0], cut_after + 1))
    lasts = np.concatenate((cut_after, [len(segments) - 1]))
    return [(int(bounds[f, 0]), int(bounds[l, 1]))
            for f, l in zip(firsts, lasts)]
