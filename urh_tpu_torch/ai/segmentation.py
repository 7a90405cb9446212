"""Noise-floor estimation (host copy of urh_tpu.ai.segmentation).

Equivalent of urh/ainterpretation/AutoInterpretation.py:60-91.  The
power-gate message segmentation of the reference module comes with the
auto-interpretation port.
"""

from __future__ import annotations

import math

import numpy as np


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
