"""The power gate of estimation on the staged capture (a CUDA kernel).

``estimate()`` gates a capture by its magnitudes twice: URH's noise floor
(:func:`~urh_tpu_torch.ai.segmentation.detect_noise_level`, a vote over the
1%-chunks' float32 means) and the messages' ranges
(:func:`~urh_tpu_torch.ai.segmentation.segment_messages_from_magnitudes`,
the gate's crossings and their hysteresis).  On the host both read a
float64 copy of the whole capture's magnitudes.  Here two passes of
``csrc/power_gate.cu`` (per-sample arithmetic in ``csrc/power_gate.cuh``)
read the capture where the device already holds it
(``IQData.staged_planes``: (n, 2) in its ingest dtype, raw units), with
each magnitude in float64 as the host computes it, to the bit:

* :func:`gate_stats`: for each 1%-chunk of detect_noise_level's layout, the
  float64 sum of the samples' float32 levels and their float32 max;
* :func:`gate_crossings`: the positions where ``magnitude > noise`` flips,
  in order, and the gate at sample 0.

Each launches the kernel for a CUDA tensor (counted in :data:`LAUNCHES`,
one a pass) and runs its plain version for a CPU one; the plain versions
repeat the kernel's arithmetic and its order of summation, so the two agree
to the bit.  The host finishes with the host path's own code:
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

from urh_tpu_torch import _build
from urh_tpu_torch.ai import segmentation as seg
from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.util.metrics import metrics

THREADS = 256  # kUrhGateThreads in csrc/power_gate.cuh
ROW_BLOCKS = 8  # kUrhGateRowBlocks: blocks a 1%-chunk in the statistics pass
TILE = THREADS * 16  # kUrhGateThreads * kUrhGateTileIters: a crossings tile

_DTYPE_CODES = {torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.uint16: 3,
                torch.float32: 4}

# kernel name -> launches since the last reset; only a kernel launch counts
LAUNCHES = {"power_gate_stats": 0, "power_gate_crossings": 0}

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
    S / L with u = 2^-24.  The card's sum of the same levels in float64 is
    within L 2^-53 S of S, its division one more rounding, so S / L <= A (1
    + 2^-29) for L < 2^23.  (64 + 2 c) u is more than twice the whole; an
    absolute 2^-148 covers the host's float32 division into the subnormal
    range."""
    return (64 + 2 * math.ceil(math.log2(chunk + 1))) * 2.0 ** -24


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor) -> bool:
    """Validate a staged capture; True for CUDA tensors, False for CPU ones."""
    if not isinstance(x, torch.Tensor) or x.dtype not in _DTYPE_CODES:
        raise TypeError("expected a torch.Tensor in an ingest dtype "
                        "(int8, uint8, int16, uint16, float32)")
    if x.dim() != 2 or x.shape[1] != 2 or not x.is_contiguous():
        raise ValueError(f"expected contiguous (n, 2) interleaved samples, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % (2 * x.element_size()):
        raise ValueError("the samples must be aligned to a whole sample")
    return x.device.type == "cuda"


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


def gate_stats_plain(x: torch.Tensor, skip: int, chunk: int) -> tuple:
    """-> (sums, maxes) of the kernel, in its order: thread c of a row
    (block c // THREADS) sums the levels at c, c + ROW_BLOCKS * THREADS, ...
    from 0.0; each block halves its threads' sums (v[t] += v[t + h], h =
    THREADS / 2 .. 1); the row adds its blocks' sums from 0.0 in order."""
    rows = (len(x) - skip) // chunk
    levels = _magnitudes(x[skip:skip + rows * chunk]).to(torch.float32).view(rows, chunk)
    maxes = levels.amax(dim=1)
    stride = ROW_BLOCKS * THREADS
    steps = -(-chunk // stride)
    padded = torch.zeros((rows, steps * stride), dtype=torch.float64, device=x.device)
    padded[:, :chunk] = levels
    acc = torch.zeros((rows, stride), dtype=torch.float64, device=x.device)
    for part in padded.view(rows, steps, stride).unbind(1):
        acc = acc + part  # a level of 0.0 past the row adds nothing
    v = acc.view(rows, ROW_BLOCKS, THREADS)
    h = THREADS // 2
    while h:
        v = v[..., :h] + v[..., h:2 * h]
        h //= 2
    sums = torch.zeros(rows, dtype=torch.float64, device=x.device)
    for b in range(ROW_BLOCKS):
        sums = sums + v[:, b, 0]
    return sums, maxes


def gate_stats(x: torch.Tensor, skip: int, chunk: int) -> tuple:
    """The statistics pass over the (len(x) - skip) // chunk rows of chunk
    samples from sample ``skip`` -> (sums float64, maxes float32) a row, on
    x's device."""
    if not _check(x):
        return gate_stats_plain(x, skip, chunk)
    rows = (len(x) - skip) // chunk
    if rows <= 0 or rows > 65535:
        raise ValueError(f"{rows} rows: the kernel takes 1 to 65,535")
    dev = x.device
    partial = torch.empty(rows * ROW_BLOCKS, dtype=torch.float64, device=dev)
    partial_max = torch.empty(rows * ROW_BLOCKS, dtype=torch.float32, device=dev)
    done = torch.zeros(rows, dtype=torch.int32, device=dev)
    sums = torch.empty(rows, dtype=torch.float64, device=dev)
    maxes = torch.empty(rows, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().urh_power_gate_stats(
            x.data_ptr(), _DTYPE_CODES[x.dtype], skip, chunk, rows, partial.data_ptr(),
            partial_max.data_ptr(), done.data_ptr(), sums.data_ptr(), maxes.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"urh_power_gate_stats launch failed with CUDA error {rc}")
    LAUNCHES["power_gate_stats"] += 1
    return sums, maxes


def gate_crossings_plain(x: torch.Tensor, noise: float) -> tuple:
    """-> (positions int32, above0): the kernel's result by torch ops."""
    above = _magnitudes(x) > noise
    positions = torch.nonzero(above[1:] != above[:-1]).flatten().to(torch.int32) + 1
    return positions, bool(len(above) and above[0])


def launch_crossings(x: torch.Tensor, noise: float) -> tuple:
    """The crossings pass over a CUDA tensor of n >= 1 samples, enqueued
    -> (positions, meta) on the card: room for n - 1 positions, the first
    meta[0] of them the crossings; meta[1] the gate at sample 0."""
    n = len(x)
    if n >= 1 << 31:
        raise ValueError(f"{n} samples: the kernel takes fewer than 2^31")
    dev = x.device
    tiles = -(-n // TILE)
    work = torch.zeros(tiles + 1, dtype=torch.int64, device=dev)
    positions = torch.empty(max(n - 1, 1), dtype=torch.int32, device=dev)
    meta = torch.empty(2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().urh_power_gate_crossings(
            x.data_ptr(), _DTYPE_CODES[x.dtype], n, float(noise), tiles, work.data_ptr(),
            positions.data_ptr(), meta.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"urh_power_gate_crossings launch failed with CUDA error {rc}")
    LAUNCHES["power_gate_crossings"] += 1
    return positions, meta


def gate_crossings(x: torch.Tensor, noise: float) -> tuple:
    """The crossings pass -> (positions, above0): the ascending positions i
    in [1, n) where ``magnitude > noise`` (float64) differs from sample i -
    1's, int32 on x's device, and the gate at sample 0."""
    if not _check(x):
        return gate_crossings_plain(x, float(noise))
    if not len(x):
        return torch.zeros(0, dtype=torch.int32, device=x.device), False
    positions, meta = launch_crossings(x, noise)
    count, above0 = meta.tolist()
    return positions[:count], bool(above0)


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
