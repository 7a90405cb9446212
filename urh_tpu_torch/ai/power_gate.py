"""The power gate of estimation on the staged capture (torch ops).

``estimate()`` gates a capture by its magnitudes twice: URH's noise floor
(:func:`~urh_tpu_torch.ai.segmentation.detect_noise_level`, a vote over the
1%-chunks' float32 means) and the messages' ranges
(:func:`~urh_tpu_torch.ai.segmentation.segment_messages_from_magnitudes`,
the gate's crossings and their hysteresis).  On the host both read a
float64 copy of the whole capture's magnitudes.  Here torch ops read the
capture where the device already holds it (``IQData.staged_planes``: (n,
2) in its ingest dtype, raw units), with each magnitude in float64 as the
host computes it, to the bit:

* :func:`gate_stats`: for each 1%-chunk of detect_noise_level's layout, the
  float64 sum of the samples' float32 levels and their float32 max;
* :func:`gate_crossings`: the positions where ``magnitude > noise`` flips,
  in order, and the gate at sample 0.

The host finishes with the host path's own code:
:func:`noise_level` settles the vote exactly (below) and
:func:`segments` runs ``segments_from_changes``.  Counters (util.metrics):
``gate.settled_rows`` (chunks whose mean the host recomputed) and
``gate.crossings`` (positions that came back); ``estimate()`` counts
``gate.card``, one a gate run on a capture staged on the card (a capture
staged on the CPU takes the host path).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from urh_tpu_torch.ai import segmentation as seg
from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.util.metrics import metrics

_INGEST_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.uint16, torch.float32)

# A row sum from here on could overflow the host's float32 sum (and an inf
# level makes it inf): the bound does not hold there, so such rows are
# settled one by one whatever their card mean.
_HOST_SUM_LIMIT = 2.0 ** 120


def mean_bound(chunk: int) -> float:
    """Relative bound on how far the card's float64 mean of a chunk (its
    float64 sum over chunk) lies from the host's float32 mean.

    NumPy's float32 mean sums pairwise: blocks of at most 128 terms in 8
    accumulators (at most 15 roundings a term, 3 to join the accumulators,
    7 for the rest), halved recursively above 128 (one rounding a level,
    at most c = ceil(log2 L) levels), after the row's first term; then one
    division.  So a term of the sum S of the L = chunk non-negative levels
    passes d <= 27 + c roundings and |M - S / L| <= ((d + 1) u / (1 - d u))
    S / L with u = 2^-24.  The card's sum of the same levels in float64 is,
    in any order of summation (torch's), within L 2^-53 S of S, its division
    one more rounding, so S / L <= A (1 + 2^-29) for L < 2^23.  (64 + 2 c) u
    is more than twice the whole; an absolute 2^-148 covers the host's
    float32 division into the subnormal range."""
    return (64 + 2 * math.ceil(math.log2(chunk + 1))) * 2.0 ** -24


# ---------------------------------------------------------------------------
# the gate's two passes
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor):
    """Validate a staged capture."""
    if not isinstance(x, torch.Tensor) or x.dtype not in _INGEST_DTYPES:
        raise TypeError("expected a torch.Tensor in an ingest dtype "
                        "(int8, uint8, int16, uint16, float32)")
    if x.dim() != 2 or x.shape[1] != 2 or not x.is_contiguous():
        raise ValueError(f"expected contiguous (n, 2) interleaved samples, got {tuple(x.shape)}")


def _magnitudes(x: torch.Tensor) -> torch.Tensor:
    """float64 magnitudes: each square exact, their sum rounded once, an
    IEEE square root (IQData.magnitudes' values)."""
    xd = x.to(torch.float64)
    squares = xd[:, 0] * xd[:, 0] + xd[:, 1] * xd[:, 1]
    if squares.device.type == "cpu":
        # torch's vectorised float64 sqrt on the CPU can miss the correctly
        # rounded root by an ulp (sqrt(2.0)); NumPy's, as the card's, is IEEE
        return torch.from_numpy(np.sqrt(squares.numpy()))
    return torch.sqrt(squares)


def gate_stats(x: torch.Tensor, skip: int, chunk: int) -> tuple:
    """The statistics pass over the (len(x) - skip) // chunk rows of chunk
    samples from sample ``skip`` -> (sums float64, maxes float32) a row, on
    x's device (summed in torch's order: mean_bound holds for any)."""
    _check(x)
    rows = (len(x) - skip) // chunk
    levels = _magnitudes(x[skip:skip + rows * chunk]).to(torch.float32).view(rows, chunk)
    return levels.to(torch.float64).sum(dim=1), levels.amax(dim=1)


def gate_crossings(x: torch.Tensor, noise: float) -> tuple:
    """The crossings pass -> (positions, above0): the ascending positions i
    in [1, n) where ``magnitude > noise`` (float64) differs from sample i -
    1's, int32 on x's device, and the gate at sample 0."""
    _check(x)
    above = _magnitudes(x) > float(noise)
    positions = torch.nonzero(above[1:] != above[:-1]).flatten().to(torch.int32) + 1
    return positions, bool(len(above) and above[0])


# ---------------------------------------------------------------------------
# the host's finish
# ---------------------------------------------------------------------------


def _settle(pick, settled, voted, lower, upper, iq_data: IQData, skip: int, chunk: int,
            bounded: bool = True):
    """Recompute the picked rows' float32 means on the host, as
    detect_noise_level computes them, into ``voted``, narrow their [lower,
    upper] to that mean and mark them ``settled``.  A bounded row whose
    mean lies outside its interval raises: mean_bound would not hold for
    this NumPy."""
    todo = np.flatnonzero(pick & ~settled)
    if not len(todo):
        return
    data = iq_data.data
    rows = np.stack([np.asarray(IQData(data[skip + r * chunk:skip + (r + 1) * chunk],
                                       skip_conversion=True).magnitudes, dtype=np.float32)
                     for r in todo])
    exact = seg.chunk_means(rows)
    metrics.count("gate.settled_rows", len(todo))
    off = (exact < lower[todo]) | (exact > upper[todo])
    if bounded and off.any():
        r = int(todo[np.argmax(off)])
        raise RuntimeError(f"row {r}'s float32 mean {exact[np.argmax(off)]!r} lies outside "
                           f"[{lower[r]!r}, {upper[r]!r}]: power_gate.mean_bound does not hold")
    voted[todo] = exact
    lower[todo] = upper[todo] = exact
    settled[todo] = True


def noise_level(staged: torch.Tensor, iq_data: IQData) -> float:
    """detect_noise_level(iq_data.magnitudes), to the bit, from the
    statistics pass over ``staged`` (iq_data's samples on a device).

    The vote decides on the host's float32 chunk means M; the card gives A
    = its float64 sum over chunk, and |A - M| <= eps = mean_bound(chunk) A
    + 2^-148.  Rows that could be the minimum or the maximum, and rows whose
    [A - eps, A + eps] holds the vote's threshold (1.1 lo, or that in
    float32, as NumPy may compare either), get M from the host's samples
    of that row, by the host's code; every other row falls on the same
    side of each decision at A (rounded to float32) as at M.  The loudest
    level of the voting rows is the max of their maxes, exact in any order,
    and the ceiling is the host's line.

    Levels are non-negative, so a row's mean is NaN exactly where its sum
    is: then the host's minimum is NaN, no row votes and the level is 0, as
    here.  A row whose sum is inf or from 2^120 on (its float32 sum may
    overflow) is settled first, whatever its card mean."""
    n = len(iq_data)
    if n <= 3:
        return 0
    skip, chunk = seg.noise_rows(n)
    sums, maxes = (t.cpu().numpy() for t in gate_stats(staged, skip, chunk))
    if np.isnan(sums).any():
        return 0
    huge = sums >= _HOST_SUM_LIMIT
    means = np.where(huge, 0.0, sums / chunk)
    eps = mean_bound(chunk) * means + 2.0 ** -148
    lower, upper = means - eps, means + eps
    lower[huge], upper[huge] = -np.inf, np.inf
    voted = means.astype(np.float32)  # settled rows get the host's mean
    settled = np.zeros(len(means), dtype=bool)
    _settle(huge, settled, voted, lower, upper, iq_data, skip, chunk, bounded=False)
    _settle((lower <= upper.min()) | (upper >= lower.max()), settled, voted, lower, upper,
            iq_data, skip, chunk)
    threshold = 1.1 * float(voted.min())
    with np.errstate(over="ignore"):  # past float32's range it compares as inf
        edge = sorted((threshold, float(np.float32(threshold))))
    _settle((upper >= edge[0]) & (lower <= edge[1]), settled, voted, lower, upper,
            iq_data, skip, chunk)
    voting = seg.quiet_rows(voted)
    if voting is None or not voting.any():
        return 0
    return seg.noise_ceiling(maxes[voting].max())


def segments(staged: torch.Tensor, noise: float) -> list:
    """segment_messages_from_magnitudes(magnitudes, noise), to the bit, from
    the crossings pass over ``staged``."""
    positions, above0 = gate_crossings(staged, noise)
    change = positions.cpu().numpy()
    metrics.count("gate.crossings", len(change))
    return seg.segments_from_changes(change, above0, len(staged))
