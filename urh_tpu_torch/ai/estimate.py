"""Automatic modulation-parameter estimation (PyTorch port of
urh_tpu.ai.estimate).

Behavioral contract: urh/ainterpretation/AutoInterpretation.py:151-471 of
the reference.  ``estimate(iq, device=None)`` runs on the CUDA card by
default:

* the capture goes to the device once (``IQData.staged_planes``); under
  ``device="auto"`` only while urh_tpu's rule holds (2N cells from
  DEVICE_MIN_CELLS on, and 8 B a sample up and 4 back cost less than
  5 ns a sample), and otherwise each stage below is placed on its own;
* noise floor and message segmentation: the power gate
  (:mod:`urh_tpu_torch.ai.power_gate`) on a capture staged on the card,
  two passes of a kernel whose chunk statistics and crossings the host
  finishes to the host path's results, bit for bit; a capture unstaged or
  staged on the CPU takes the host path (NumPy, on the magnitudes);
* modulation classification gathers the sampled messages from there,
  bucket by bucket (:func:`urh_tpu_torch.ai.device.classification_stats_staged`,
  one B7 launch a bucket), and applies the variance and spectral
  thresholds to the scalars that come back;
* ``afp_demod`` demodulates the staged capture on the device, and the
  rectangular signal comes back once;
* the per-message scans (center, plateau lengths, tolerance, bit length)
  run on the host, their histograms on the device;
* the final vote over the per-message results is a small host reduction.

It returns ``{modulation_type, bit_length, center, tolerance, noise}``.
Each stage runs in a :mod:`urh_tpu_torch.util.metrics` span, in this
order: ``estimate.stage``, ``estimate.noise`` (noise floor: the gate's
statistics pass, or the host's magnitudes and vote), ``estimate.segment``
(the gate's crossings pass and the hysteresis), ``estimate.classify`` (with
the OOK merge), ``estimate.rect`` and ``estimate.scan`` (with the vote); the
counter ``gate.card`` counts the gates run on a capture staged on the card.
"""

from __future__ import annotations

import itertools
import math
from collections import Counter

import numpy as np

from urh_tpu_torch.ai import device as ai_device
from urh_tpu_torch.ai import kernels as _k
from urh_tpu_torch.ai import power_gate
from urh_tpu_torch.ai.segmentation import (
    detect_noise_level,
    max_without_outliers,
    merge_message_segments_for_ook,
    min_without_outliers,
    segment_messages_from_magnitudes,
)
from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.dsp import demod as _demod
from urh_tpu_torch.util import placement
from urh_tpu_torch.util.metrics import metrics

# classification thresholds (AutoInterpretation.py:151-207)
_OOK_MAX_ZEROS = 3  # more gated-out samples than this means on/off keying
_OOK_VARIANCE_CEILING = 0.15  # all four variances below -> OOK
_ASK_RATIO = 1.5  # var(mag) vs var(norm mag)
_PSK_RATIO = 10.0  # var(mag) vs var(median-filtered mag)
_WAVELET_SCALE = 4
_MEDIAN_ORDER = 11
_MAX_CLASSIFIED_MESSAGES = 100


def get_most_frequent_value(values: list):
    """Most frequent value; ties resolve to the maximum among the most
    frequent (AutoInterpretation.py:28-47)."""
    if len(values) == 0:
        return None
    ranked = Counter(values).most_common()
    winner, top_count = ranked[0]
    for value, count in ranked:
        if count < top_count:
            return winner
        winner = value
    return winner


def most_common(values: list):
    """Most common value; ties resolve to first appearance."""
    counter = Counter(values)
    return max(values, key=counter.get)


# ---------------------------------------------------------------------------
# modulation classification (batched)
# ---------------------------------------------------------------------------


def _decide_modulation(var_mag, var_norm, var_fmag, var_fnorm, is_fsk) -> str:
    if max(var_mag, var_norm, var_fmag, var_fnorm) < _OOK_VARIANCE_CEILING:
        return "OOK"
    if var_mag > _ASK_RATIO * var_norm:
        return "ASK"
    if var_mag > _PSK_RATIO * var_fmag:
        return "PSK"
    return "FSK" if is_fsk else "OOK"


def bucket_segments(iq_data: IQData, segments: list, wavelet_scale=_WAVELET_SCALE,
                    staged: bool = False) -> tuple:
    """-> (decisions, staged_buckets, buckets): the decisions taken without
    statistics (None elsewhere), and the rest of the segments grouped by
    their power-of-two width, each group one batch of statistics (one B7
    launch).  Segments are zero-filtered, truncated to the power-of-two
    floor of their zero-free length, and grouped by it.  With ``staged``,
    a segment whose first ``width`` samples hold no zero goes to
    ``staged_buckets`` as (index, start), to be gathered on the device;
    the others go to ``buckets`` as (index, samples)."""
    data = iq_data.as_complex64_view()  # read-only consumer: zero-copy
    decisions = [None] * len(segments)
    buckets: dict = {}
    staged_buckets: dict = {}

    for i, (start, end) in enumerate(segments):
        samples = data[start:end]
        dead = np.flatnonzero(np.abs(samples) == 0)
        n_alive = len(samples) - len(dead)
        if n_alive == 0:
            continue
        if len(dead) > _OOK_MAX_ZEROS:
            decisions[i] = "OOK"
            continue
        width = ai_device.pow2_floor(n_alive)
        if width <= 4 * wavelet_scale:
            continue  # CWT support vanishes: undecidable
        if staged and (len(dead) == 0 or dead.min() >= width):
            # first `width` alive samples are the contiguous prefix
            staged_buckets.setdefault(width, []).append((i, start))
        else:
            alive = np.delete(samples, dead) if len(dead) else samples
            buckets.setdefault(width, []).append((i, alive[:width]))
    return decisions, staged_buckets, buckets


def classify_messages(iq_data: IQData, segments: list, wavelet_scale=_WAVELET_SCALE,
                      median_filter_order=_MEDIAN_ORDER, staged=None, device=None) -> list:
    """Modulation decision per message segment (None = undecidable).

    Each width bucket runs through one batch of statistics on the device;
    only the threshold comparison stays on the host.  With ``staged`` (the
    capture resident on a device, ``IQData.staged_planes``), zero-free
    segments are gathered there and only their start offsets cross PCIe;
    the other buckets are uploaded to ``staged``'s device, or to ``device``
    (default: the CUDA card) without it."""
    device = staged.device if staged is not None else placement.requested(device)
    decisions, staged_buckets, buckets = bucket_segments(
        iq_data, segments, wavelet_scale, staged=staged is not None)

    def apply(members, stats):
        for row, (i, _) in enumerate(members):
            decisions[i] = _decide_modulation(
                stats["var_mag"][row], stats["var_norm_mag"][row],
                stats["var_filtered_mag"][row],
                stats["var_filtered_norm_mag"][row], stats["is_fsk"][row])

    for width, members in staged_buckets.items():
        apply(members, ai_device.classification_stats_staged(
            staged, [s for _, s in members], width, scale=wavelet_scale,
            median_k=median_filter_order))
    for width, members in buckets.items():
        batch = np.stack([row for _, row in members])
        apply(members, ai_device.classification_stats(
            batch, scale=wavelet_scale, median_k=median_filter_order, device=device))
    return decisions


def detect_modulation(message_samples: np.ndarray, wavelet_scale=4,
                      median_filter_order=11, device=None) -> str:
    """Single-message classification (unit-test surface; estimate() uses
    the batched classify_messages path)."""
    container = IQData(np.stack([message_samples.real.astype(np.float32),
                                 message_samples.imag.astype(np.float32)],
                                axis=1), skip_conversion=True)
    return classify_messages(container, [(0, len(message_samples))],
                             wavelet_scale=wavelet_scale,
                             median_filter_order=median_filter_order, device=device)[0]


def detect_modulation_for_messages(iq_data: IQData, message_indices: list,
                                   staged=None, device=None):
    sampled = message_indices[:_MAX_CLASSIFIED_MESSAGES]
    found = [d for d in classify_messages(iq_data, sampled, staged=staged, device=device)
             if d is not None]
    return most_common(found) if found else None


# ---------------------------------------------------------------------------
# per-message parameter extraction
# ---------------------------------------------------------------------------


def detect_center(rectangular_signal: np.ndarray, max_size=None, device=None):
    """Mean of the two dominant histogram levels of the rectangular
    signal (AutoInterpretation.py:226-277); edge 5% discarded.  The
    histogram is counted on ``device`` (default: the CUDA card)."""
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
        counts = ai_device.histogram(rect, edges, device=device)
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


def estimate_tolerance_from_plateau_lengths(plateau_lengths, relative_max=0.05):
    """Glitch tolerance = largest run length still below ``relative_max``
    of the (outlier-free) maximum; the shortest run being already long
    means zero tolerance."""
    if len(plateau_lengths) <= 1:
        return None
    unique = np.unique(plateau_lengths)
    limit = relative_max * max_without_outliers(unique, z=2)
    if unique[0] > 1 and unique[0] >= limit:
        return 0
    # first value that is both > 1 and >= limit ends the glitch zone
    glitch_zone = unique[: np.searchsorted(unique, max(2.0, limit), side="left")]
    return int(glitch_zone[-1]) if len(glitch_zone) else 0


def merge_plateau_lengths(plateau_lengths, tolerance=None):
    if tolerance is None:
        tolerance = estimate_tolerance_from_plateau_lengths(plateau_lengths)
    if not tolerance:
        return plateau_lengths
    return _k.merge_plateaus(plateau_lengths, tolerance, max_count=10000)


def round_plateau_lengths(plateau_lengths):
    """Round lengths at the leading-digit resolution of the median value,
    e.g. 99 -> 100, 293 -> 300 (AutoInterpretation.py:313-326)."""
    digits = min(3, int(np.percentile([len(str(p)) for p in plateau_lengths], 50)))
    unit = 10 ** (digits - 1)
    plateau_lengths[:] = [int(round(p / unit)) * unit for p in plateau_lengths]


def get_tolerant_greatest_common_divisor(numbers):
    gcds = [g for g in (math.gcd(x, y)
                        for x, y in itertools.combinations(numbers, 2)) if g != 1]
    return get_most_frequent_value(gcds) if gcds else 1


def get_bit_length_from_plateau_lengths(merged_plateau_lengths) -> int:
    """Bit length = best-voted approximate divisor of the plateau
    lengths, preferring the smallest divisor within 25% of the top vote
    (a bare argmax could be a multiple of the true length)."""
    if len(merged_plateau_lengths) == 0:
        return 0
    if len(merged_plateau_lengths) == 1:
        return int(merged_plateau_lengths[0])

    lengths = np.array(merged_plateau_lengths, dtype=np.uint64)
    round_plateau_lengths(lengths)
    votes = _k.get_threshold_divisor_histogram(lengths)
    if len(votes) == 0:
        return 0

    by_vote = np.argsort(votes)[::-1]
    winner = by_vote[0]
    floor_votes = 0.25 * votes[winner]
    for candidate in by_vote[1:]:
        if votes[candidate] < floor_votes:
            break
        if candidate <= 0.5 * winner:
            winner = candidate
    return int(winner)


def _message_parameters(rect: np.ndarray, device=None) -> tuple:
    """(center, bit_length, tolerance) of one message's rectangular
    signal; center/bit_length are None when undecidable, but a computed
    tolerance is reported regardless (it feeds the tolerance vote even
    for messages whose bit length cannot be established)."""
    center = detect_center(rect, device=device)
    if center is None:
        return None, None, None

    plateaus = _k.get_plateau_lengths(rect, center, percentage=25)
    tolerance = estimate_tolerance_from_plateau_lengths(plateaus)

    merged = merge_plateau_lengths(plateaus, tolerance=tolerance or 0)
    if len(merged) < 2:
        return None, None, tolerance

    bit_length = get_bit_length_from_plateau_lengths(merged)
    if bit_length <= (tolerance or 0) + 1:
        return None, None, tolerance
    return center, bit_length, tolerance


# ---------------------------------------------------------------------------
# top-level estimation
# ---------------------------------------------------------------------------


def stage(iq_array: IQData, device):
    """The capture's (n, 2) planes staged on ``device``, or None where
    placement keeps it on the host.  The capture goes to the device once:
    the power gate, classification and demodulation all read it from
    there.  Under "auto" only while moving it (8 B a sample up, qad 4 B
    back) costs less than urh_tpu's host pipeline, 5 ns a sample; unstaged,
    the gate runs on the host and each stage of estimate() is placed on its
    own."""
    n_samples = len(iq_array)
    staging, side = placement.choose(
        "ai.estimate.staging", device,
        lambda: ai_device.use_device(2 * n_samples)
        and placement.device_io_cost_s(8 * n_samples, 4 * n_samples) < n_samples * 5e-9)
    return iq_array.staged_planes(staging) if side != "host" else None


def gates(staged) -> bool:
    """Whether the power gate reads a staged capture: only on the card.  A
    capture staged on the CPU takes the host path (one NumPy pass), which
    the gate's plain version would only repeat in two float64 passes."""
    return staged is not None and staged.device.type == "cuda"


def estimate(iq_array, noise: float = None, modulation: str = None, device=None) -> dict:
    """Modulation type, bit length, center, tolerance and noise of a capture
    ((N, 2) numpy in an ingest dtype, or an IQData), on ``device`` (default:
    the CUDA card; ``"auto"`` places it); None when undecidable."""
    device = placement.requested(device)
    if isinstance(iq_array, np.ndarray):
        iq_array = IQData(iq_array)

    with metrics.span("estimate.stage"):
        staged = stage(iq_array, device)

    if not gates(staged):
        with metrics.span("estimate.noise"):
            magnitudes = iq_array.magnitudes
            if noise is None:
                noise = detect_noise_level(magnitudes)
        with metrics.span("estimate.segment"):
            segments = segment_messages_from_magnitudes(magnitudes, noise_threshold=noise)
    else:
        metrics.count("gate.card")
        with metrics.span("estimate.noise"):
            if noise is None:
                noise = power_gate.noise_level(staged, iq_array)
        with metrics.span("estimate.segment"):
            segments = power_gate.segments(staged, noise)

    with metrics.span("estimate.classify"):
        if modulation is None:
            modulation = detect_modulation_for_messages(iq_array, segments, staged=staged,
                                                        device=device)
        if modulation == "OOK":
            segments = merge_message_segments_for_ook(segments)
    if modulation is None:
        return None

    demod_kind = "ASK" if modulation in ("OOK", "ASK") else modulation
    if demod_kind not in ("ASK", "FSK", "PSK"):
        raise ValueError("unsupported modulation")
    with metrics.span("estimate.rect"):
        rect = _demod.afp_demod(staged if staged is not None else iq_array.data, noise,
                                demod_kind, 2, dtype=iq_array.data.dtype,
                                device=device).cpu().numpy()

    with metrics.span("estimate.scan"):
        centers, bit_lengths, tolerances = [], [], []
        for start, end in segments:
            center, bit_length, tolerance = _message_parameters(rect[start:end],
                                                                device=device)
            if tolerance is not None:
                tolerances.append(tolerance)
            if center is not None:
                centers.append(center)
                bit_lengths.append(bit_length)

        if modulation in ("OOK", "ASK"):
            # ASK center tends toward the minimum of found centers
            center = min_without_outliers(np.array(centers), z=2)
        else:
            center = np.mean(centers) if centers else None
        if center is None:
            return None

        bit_length = get_most_frequent_value(bit_lengths)
        if bit_length is None:
            return None

        tolerance = (int(np.percentile(tolerances, 50)) if tolerances
                     else max(1, int(0.05 * bit_length)))

    return {
        "modulation_type": "ASK" if modulation == "OOK" else modulation,
        "bit_length": bit_length,
        "center": center,
        "tolerance": tolerance,
        "noise": noise,
    }
