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
  torch ops whose chunk statistics and crossings the host finishes to the
  host path's results, bit for bit; a capture unstaged or staged on the
  CPU takes the host path (NumPy, on the magnitudes);
* modulation classification gathers the sampled messages from there,
  bucket by bucket (:func:`urh_tpu_torch.ai.device.classification_stats_staged`,
  one B7 launch a bucket), and applies the variance and spectral
  thresholds to the scalars that come back;
* ``afp_demod`` demodulates the staged capture on the device, and the
  rectangular signal comes back once;
* the per-message scans make one batched pass (:func:`scan_messages`):
  every message's center histogram in one device call
  (:func:`urh_tpu_torch.ai.device.histograms`, reading the rectangular
  signal where it lies on the card), every message's plateau lengths,
  tolerance, rounding and divisor vote in host passes over all messages,
  the glitch merge message by message;
* the final vote over the per-message results is a small host reduction.

It returns ``{modulation_type, bit_length, center, tolerance, noise}``.
Each stage runs in a :mod:`urh_tpu_torch.util.metrics` span, in this
order: ``estimate.stage``, ``estimate.noise`` (noise floor: the gate's
statistics pass, or the host's magnitudes and vote), ``estimate.segment``
(the gate's crossings pass and the hysteresis), ``estimate.classify`` (with
the OOK merge), ``estimate.rect`` and ``estimate.scan``, which holds
``estimate.scan.center`` (the values' statistics, the batched histogram,
the peaks), ``estimate.scan.plateaus`` (runs, tolerance, merge) and
``estimate.scan.vote`` (rounding, divisor histograms, bit lengths, the
vote).  The counter ``gate.card`` counts the gates run on a capture staged
on the card, ``classify.screened_samples`` the samples of the segments
classification read on the host, ``scan.messages`` the messages scanned and
``scan.histogram_calls`` the device calls that counted their centers' histograms.
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
from urh_tpu_torch.core.xfer import to_host
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
# detect_center counts the rectangular signal's values above this; the noise
# sentinel lies at or below it
_SENTINEL_BOUND = -4


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
    the others go to ``buckets`` as (index, samples).  Only the segments'
    samples are converted to complex64 (a float32 capture is read in place);
    their count goes to the counter ``classify.screened_samples``."""
    decisions = [None] * len(segments)
    buckets: dict = {}
    staged_buckets: dict = {}

    metrics.count("classify.screened_samples", int(sum(end - start for start, end in segments)))
    for i, (start, end) in enumerate(segments):
        samples = iq_data.complex64_range(start, end)
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
    histogram is counted on ``device`` (default: the CUDA card).  One
    message of :func:`detect_centers`."""
    return detect_centers(rectangular_signal, [(0, len(rectangular_signal))],
                          max_size=max_size, device=device)[0]


def detect_centers(rect: np.ndarray, segments: list, max_size=None, device=None,
                   resident=None) -> list:
    """detect_center of each message segment rect[start:end], every
    histogram counted in one call of :func:`ai_device.histograms` on
    ``device`` (the counter ``scan.histogram_calls``); ``resident`` is rect
    as it lies on a device, whose values the histograms read there.  Each
    message's values, bounds and bin width (its float32 variance) are taken
    on the host as detect_center takes them: one float32 ulp of the width can
    move the center."""
    values, spans, edges, members = [], [], [], []
    for m, (start, end) in enumerate(segments):
        message = rect[start:end]
        kept = _kept(message, message > _SENTINEL_BOUND)
        first, last = int(0.05 * len(kept)), int(0.95 * len(kept))
        if max_size is not None and last - first > max_size:
            last = first + max_size
        counted = kept[first:last]
        if len(counted) == 0:
            continue
        lo, hi = float(np.min(counted)), float(np.max(counted))
        step = float(np.var(counted))
        try:
            edges.append(np.arange(lo, hi + step, step))
        except (ZeroDivisionError, ValueError, MemoryError):
            continue  # constant segment: no center to find
        values.append(counted)
        spans.append((start, end, first, last))
        members.append(m)

    centers = [None] * len(segments)
    if members:
        metrics.count("scan.histogram_calls")
        counts = ai_device.histograms(
            values, edges, device=device,
            resident=None if resident is None else (resident, spans, _SENTINEL_BOUND))
        for m, c, e in zip(members, counts, edges):
            peaks = _dominant_local_maxima(c, e, wanted=2)
            centers[m] = np.mean(peaks) if peaks else None
    return centers


def _kept(values: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """values[keep]: a view where the kept values are one run (a message's
    noise sentinels only at its ends), else the copy."""
    n = int(np.count_nonzero(keep))
    first = int(np.argmax(keep)) if n else 0
    if keep[first:first + n].all():
        return values[first:first + n]
    return values[keep]


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
    means zero tolerance.  One message of :func:`tolerances`."""
    return tolerances([plateau_lengths], relative_max)[0]


# how near its bound a distinct length's distance from the mean may lie
# before the bound is taken as NumPy takes it: far above the rounding of a
# sum of squares in another order (n * 2^-53 of it for n terms)
_Z_MARGIN = 1e-9


def tolerances(plateaus: list, relative_max=0.05) -> list:
    """estimate_tolerance_from_plateau_lengths of each message's integer
    plateau lengths, in one pass over all of them.  The outlier test keeps a
    message's distinct lengths within 2 standard deviations of their mean.
    The mean is NumPy's exactly: their sum is an integer below 2^53.  The
    standard deviation is summed in another order than NumPy's, so a length
    whose distance lies within _Z_MARGIN of the bound sends its message
    through NumPy's own test."""
    found = [None] * len(plateaus)
    scanned = [i for i, p in enumerate(plateaus) if len(p) > 1]
    exact = [i for i in scanned if not np.issubdtype(np.asarray(plateaus[i]).dtype, np.integer)]
    batch = sorted(set(scanned) - set(exact))
    if batch:
        counts = np.array([len(plateaus[i]) for i in batch], dtype=np.int64)
        lengths = np.concatenate([np.asarray(plateaus[i]) for i in batch])
        message = np.repeat(np.arange(len(batch)), counts)
        order = np.lexsort((lengths, message))
        lengths, message = lengths[order], message[order]
        new = np.ones(len(lengths), dtype=bool)
        new[1:] = (lengths[1:] != lengths[:-1]) | (message[1:] != message[:-1])
        value, owner = lengths[new], message[new]  # each message's distinct lengths, ascending
        per = np.bincount(owner, minlength=len(batch))
        first = np.cumsum(per) - per
        mean = np.add.reduceat(value.astype(np.int64), first).astype(np.float64) / per
        distance = np.abs(value.astype(np.float64) - mean[owner])
        bound = 2 * np.sqrt(np.add.reduceat(distance * distance, first) / per)
        inside = distance <= bound[owner] * (1 - _Z_MARGIN)
        unsure = np.zeros(len(batch), dtype=bool)
        unsure[owner[~inside & (distance <= bound[owner] * (1 + _Z_MARGIN))]] = True
        kept_max = np.zeros(len(batch), dtype=value.dtype)
        np.maximum.at(kept_max, owner[inside], value[inside])
        limit = relative_max * kept_max
        smallest = value[first]
        below = value < np.maximum(2.0, limit)[owner]
        glitch = np.zeros(len(batch), dtype=value.dtype)
        np.maximum.at(glitch, owner[below], value[below])
        for m, i in enumerate(batch):
            if unsure[m]:
                exact.append(i)
            elif smallest[m] > 1 and smallest[m] >= limit[m]:
                found[i] = 0
            else:
                found[i] = int(glitch[m])
    for i in exact:
        found[i] = _tolerance_by_numpy(plateaus[i], relative_max)
    return found


def _tolerance_by_numpy(plateau_lengths, relative_max: float) -> int:
    """One message's tolerance with NumPy's own outlier test."""
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


# 10 ** 1 ... 10 ** 19: a length's decimal digits are 1 + the powers at or below it
_POWERS_OF_TEN = np.array([10 ** k for k in range(1, 20)], dtype=np.uint64)


def round_plateau_lengths(plateau_lengths):
    """Round integer lengths at the leading-digit resolution of the median
    value, e.g. 99 -> 100, 293 -> 300 (AutoInterpretation.py:313-326).  One
    message of :func:`_rounded`."""
    lengths = np.asarray(plateau_lengths, dtype=np.uint64)
    rounded = _rounded(lengths, np.array([len(lengths)]))
    plateau_lengths[:] = rounded if isinstance(plateau_lengths, np.ndarray) else rounded.tolist()


def _rounded(lengths: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """round_plateau_lengths of messages laid end to end (counts[m] uint64
    lengths each, at least one): the median of each message's decimal digit
    counts (np.percentile's 50th of integers: the middle one, or the floor of
    the two middle ones' mean), and each length / unit rounded half to even
    as Python's round rounds a float."""
    message = np.repeat(np.arange(len(counts)), counts)
    digits = 1 + np.searchsorted(_POWERS_OF_TEN, lengths, side="right")
    digits = digits[np.lexsort((digits, message))]
    mid = np.cumsum(counts) - counts + (counts - 1) // 2
    median = np.where(counts % 2 == 1, digits[mid],
                      (digits[mid] + digits[np.minimum(mid + 1, len(digits) - 1)]) // 2)
    unit = (10 ** (np.minimum(3, median) - 1))[message]
    return np.rint(lengths / unit).astype(np.uint64) * unit.astype(np.uint64)


def get_tolerant_greatest_common_divisor(numbers):
    gcds = [g for g in (math.gcd(x, y)
                        for x, y in itertools.combinations(numbers, 2)) if g != 1]
    return get_most_frequent_value(gcds) if gcds else 1


def get_bit_length_from_plateau_lengths(merged_plateau_lengths) -> int:
    """Bit length = best-voted approximate divisor of the plateau
    lengths, preferring the smallest divisor within 25% of the top vote
    (a bare argmax could be a multiple of the true length).  One message
    of :func:`bit_lengths`."""
    if len(merged_plateau_lengths) == 0:
        return 0
    if len(merged_plateau_lengths) == 1:
        return int(merged_plateau_lengths[0])
    return bit_lengths([merged_plateau_lengths])[0]


def bit_lengths(merged: list) -> list:
    """get_bit_length_from_plateau_lengths of each message's merged plateau
    lengths (two or more each), the rounding and the divisor votes of every
    message in one pass.

    A message's vote walks the lengths by descending votes (np.argsort's
    order over the divisor histogram, reversed) while a length keeps a
    quarter of the top vote, and moves the winner to a length at most half
    of it.  Votes above zero fall only on the message's distinct lengths;
    where those that keep a quarter of the top vote are all distinct, their
    order is the votes' own.  A top vote of 0 or a tie among them takes
    np.argsort's order over the message's whole histogram."""
    counts = np.array([len(m) for m in merged], dtype=np.int64)
    lengths = _rounded(np.concatenate([np.asarray(m, dtype=np.uint64) for m in merged]), counts)
    message = np.repeat(np.arange(len(merged)), counts)

    # each message's distinct nonzero lengths, ascending, and how often each comes
    order = np.lexsort((lengths, message))
    lengths, message = lengths[order], message[order]
    new = np.ones(len(lengths), dtype=bool)
    new[1:] = (lengths[1:] != lengths[:-1]) | (message[1:] != message[:-1])
    at = np.flatnonzero(new)
    times = np.diff(np.append(at, len(lengths)))
    value, owner = lengths[at], message[at]
    nonzero = value != 0
    value, owner, times = value[nonzero], owner[nonzero], times[nonzero]

    # every pair i < j of one message's distinct lengths, as the divisor
    # histogram compares it: min value[i], max value[j]
    per = np.bincount(owner, minlength=len(merged))
    after = (np.cumsum(per) - per)[owner] + per[owner] - 1 - np.arange(len(value))
    i = np.repeat(np.arange(len(value)), after)
    j = i + 1 + np.arange(len(i)) - np.repeat(np.cumsum(after) - after, after)
    u = value.astype(np.float64)
    hit = u[j] / u[i] - (value[j] // value[i]).astype(np.float64) < 0.2
    partners = np.bincount(i[hit], weights=times[j[hit]], minlength=len(value))
    votes = times * (times - 1) // 2 + times * partners.astype(np.int64)

    top = np.zeros(len(merged), dtype=np.int64)
    np.maximum.at(top, owner, votes)
    ahead = votes >= 0.25 * top[owner]
    ranked = np.lexsort((-votes[ahead], owner[ahead]))
    walk_owner, walk_votes = owner[ahead][ranked], votes[ahead][ranked]
    walk_value = value[ahead][ranked].tolist()
    tied = np.zeros(len(merged), dtype=bool)
    tied[walk_owner[1:][(walk_owner[1:] == walk_owner[:-1]) & (walk_votes[1:] == walk_votes[:-1])]] = True
    first = np.searchsorted(walk_owner, np.arange(len(merged) + 1)).tolist()

    found = []
    for m in range(len(merged)):
        if top[m] == 0 or tied[m]:
            found.append(_vote_in_argsort_order(lengths[message == m]))
            continue
        winner = walk_value[first[m]]
        for candidate in walk_value[first[m] + 1:first[m + 1]]:
            if candidate <= 0.5 * winner:
                winner = candidate
        found.append(int(winner))
    return found


def _vote_in_argsort_order(lengths: np.ndarray) -> int:
    """A message's vote over its whole divisor histogram, in np.argsort's
    order: the winner moves at most log2(winner) times."""
    votes = _k.get_threshold_divisor_histogram(lengths)
    by_vote = np.argsort(votes)[::-1]
    by_vote = by_vote[:int(np.count_nonzero(votes >= 0.25 * votes[by_vote[0]]))]
    winner, k = by_vote[0], 1
    while True:
        smaller = np.flatnonzero(by_vote[k:] <= 0.5 * winner)
        if len(smaller) == 0:
            return int(winner)
        k += int(smaller[0])
        winner = by_vote[k]
        k += 1


def _message_parameters(rect: np.ndarray, device=None) -> tuple:
    """(center, bit_length, tolerance) of one message's rectangular
    signal; center/bit_length are None when undecidable, but a computed
    tolerance is reported regardless (it feeds the tolerance vote even
    for messages whose bit length cannot be established).  One message of
    :func:`scan_messages`."""
    return scan_messages(rect, [(0, len(rect))], device=device)[0]


def message_plateaus(rect: np.ndarray, segments: list, centers: list) -> list:
    """(tolerance, merged plateau lengths) of each segment with a center,
    None for the others: the plateau lengths of every segment in one pass."""
    found = [i for i, center in enumerate(centers) if center is not None]
    plateaus = _k.plateau_lengths_of_spans(rect, [segments[i] for i in found],
                                           [centers[i] for i in found], percentage=25)
    scans = [None] * len(segments)
    for i, lengths, tolerance in zip(found, plateaus, tolerances(plateaus)):
        scans[i] = tolerance, merge_plateau_lengths(lengths, tolerance=tolerance or 0)
    return scans


def message_parameters(centers: list, scans: list) -> list:
    """(center, bit_length, tolerance) of each message from its center and
    its plateau scan (see _message_parameters); the bit lengths of all in one
    pass."""
    voted = [i for i, scan in enumerate(scans) if scan is not None and len(scan[1]) >= 2]
    lengths = dict(zip(voted, bit_lengths([scans[i][1] for i in voted]) if voted else []))
    params = []
    for i, (center, scan) in enumerate(zip(centers, scans)):
        if scan is None:
            params.append((None, None, None))
            continue
        tolerance = scan[0]
        if i not in lengths or lengths[i] <= (tolerance or 0) + 1:
            params.append((None, None, tolerance))
        else:
            params.append((center, lengths[i], tolerance))
    return params


def scan_messages(rect: np.ndarray, segments: list, device=None) -> list:
    """(center, bit_length, tolerance) of each message segment of the
    rectangular signal: the centers' histograms in one device call, the
    plateau lengths in one pass, then each message's small arrays."""
    centers = detect_centers(rect, segments, device=device)
    return message_parameters(centers, message_plateaus(rect, segments, centers))


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
    the gate's torch ops would only repeat in two float64 passes."""
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
        resident = _demod.afp_demod(staged if staged is not None else iq_array.data, noise,
                                    demod_kind, 2, dtype=iq_array.data.dtype, device=device)
        rect = to_host(resident)

    with metrics.span("estimate.scan"):
        metrics.count("scan.messages", len(segments))
        with metrics.span("estimate.scan.center"):
            # on the card the histograms read the rect there; on the CPU
            # laying the values out is one copy, cheaper than selecting them
            centers = detect_centers(rect, segments, device=device,
                                     resident=resident if resident.is_cuda else None)
        with metrics.span("estimate.scan.plateaus"):
            scans = message_plateaus(rect, segments, centers)
        with metrics.span("estimate.scan.vote"):
            return _vote(message_parameters(centers, scans), modulation, noise)


def _vote(params: list, modulation: str, noise: float) -> dict:
    """The estimate from every message's (center, bit_length, tolerance)."""
    centers, bit_lengths, tolerances = [], [], []
    for center, bit_length, tolerance in params:
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
