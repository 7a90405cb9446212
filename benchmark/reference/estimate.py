"""Plain NumPy parameter estimation: URH's auto-interpretation
(urh/ainterpretation/AutoInterpretation.py, auto_interpretation.pyx)
written out again for the benchmark.

The noise floor from the quietest 1% chunks, the power-gate segmentation
with its 10-sample hysteresis, the modulation decision from the variances
of Haar-wavelet magnitudes (raw and median-filtered) and the FSK spectral
test, OOK's merge of pulse groups, the demodulation, and per message the
center from the two dominant histogram levels, the plateau lengths, the
glitch tolerance and the bit length by the approximate-divisor vote; the
votes over the messages give the parameters.
"""

from __future__ import annotations

import itertools
import math
from collections import Counter

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from benchmark.reference import demod

HYSTERESIS = 10
OOK_MAX_ZEROS = 3
OOK_VARIANCE_CEILING = 0.15
ASK_RATIO = 1.5
PSK_RATIO = 10.0
WAVELET_SCALE = 4
MEDIAN_K = 11
MAX_CLASSIFIED = 100
FFT_PEAK_DISTANCE = 10
FFT_PEAK_POWER = 100
FFT_PEAKS = 10


def magnitudes(x: np.ndarray) -> np.ndarray:
    return np.sqrt(np.einsum("ij,ij->i", x, x, dtype=np.float64))


def without_outliers(data: np.ndarray, z: float) -> np.ndarray:
    data = np.asarray(data)
    return data[np.abs(data - data.mean()) <= z * data.std()]


def noise_level(mags: np.ndarray) -> float:
    n = len(mags)
    if n <= 3:
        return 0
    chunk = max(1, n // 100)
    rows = np.asarray(mags[n % chunk:], dtype=np.float32).reshape(-1, chunk)
    means = rows.mean(axis=1, dtype=np.float32)
    lo, hi = float(means.min()), float(means.max())
    if hi == 0 or lo / hi > 0.9:
        return 0
    quiet = rows[means <= 1.1 * lo]
    return math.ceil(float(quiet.max()) * 10000) / 10000


def segments(mags: np.ndarray, noise: float) -> list:
    """[(start, end)]: a state flips at the 10th consecutive sample on the
    other side of the noise level, and a segment's bound is one sample before
    the flipping run starts."""
    n = len(mags)
    if n == 0:
        return []
    above = mags > noise
    change = np.flatnonzero(above[1:] != above[:-1]) + 1
    starts = np.concatenate(([0], change))
    lens = np.concatenate((change, [n])) - starts
    pol = np.where(above[starts], 1, -1)
    state = pol[0]
    l_pol, l_starts = pol[lens >= HYSTERESIS], starts[lens >= HYSTERESIS]
    if len(l_pol):
        keep = np.ones(len(l_pol), bool)
        keep[1:] = l_pol[1:] != l_pol[:-1]
        l_pol, l_starts = l_pol[keep], l_starts[keep]
        if l_pol[0] == state:
            l_pol, l_starts = l_pol[1:], l_starts[1:]
    out, cur_start, cur = [], 0, state
    for p, s in zip(l_pol.tolist(), l_starts.tolist()):
        if cur == 1:
            out.append((cur_start, s - 1))
        else:
            cur_start = s - 1
        cur = -cur
    if cur == 1:
        below = int(lens[-1]) if pol[-1] == -1 else 0
        if cur_start < n - below:
            out.append((cur_start, n - below))
    return out


def merge_ook(segs: list) -> list:
    if len(segs) <= 1:
        return segs
    b = np.asarray(segs, np.int64)
    pulse = b[:, 1] - b[:, 0]
    pause = b[1:, 0] - b[:-1, 1]
    cut = np.flatnonzero(pause >= 8 * np.min(without_outliers(pulse, 1)))
    firsts = np.concatenate(([0], cut + 1))
    lasts = np.concatenate((cut, [len(segs) - 1]))
    return [(int(b[f, 0]), int(b[l, 1])) for f, l in zip(firsts, lasts)]


def haar_spectrum(n: int, scale: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    omega = (2.0 * np.pi / n) * np.where(k < n // 2, k, -k)
    denom = np.where(omega == 0.0, 1.0, omega)
    return np.sqrt(2.0 * np.pi * scale) * (1j * np.square(np.exp(0.5j * scale * omega) - 1.0)
                                           / denom)


def forward_median(rows: np.ndarray, k: int) -> np.ndarray:
    """out[i] = the value at index kk // 2 of sorted(row[i:i + k]) (kk the
    window's size, shrunk at the row's end)."""
    w = rows.shape[-1]
    k = min(k, w)
    out = np.empty_like(rows)
    full = w - k + 1
    out[:, :full] = np.partition(sliding_window_view(rows, k, axis=-1), k // 2, axis=-1)[..., k // 2]
    for i in range(full, w):
        tail = np.sort(rows[:, i:], axis=-1)
        out[:, i] = tail[:, (w - i) // 2]
    return out


def classify(rows: np.ndarray) -> list:
    """Modulation decisions of a bucket of equal-width complex rows."""
    rows = rows.astype(np.complex64)
    # the largest under NumPy's complex order: real part first, then imaginary
    top_re = rows.real.max(axis=-1, keepdims=True)
    top_im = np.where(rows.real == top_re, rows.imag, -np.inf).max(axis=-1, keepdims=True)
    data = rows / np.hypot(top_re, top_im)
    unit = rows / np.abs(rows)
    psi = haar_spectrum(rows.shape[-1], WAVELET_SCALE).astype(np.complex64)
    fwd = np.fft.fft(data, axis=-1)
    cut = slice(2 * WAVELET_SCALE, -2 * WAVELET_SCALE)
    mags = np.concatenate((np.abs(np.fft.ifft(fwd * psi, axis=-1)[:, cut]),
                           np.abs(np.fft.ifft(np.fft.fft(unit, axis=-1) * psi, axis=-1)[:, cut])))
    mags = mags.astype(np.float32)
    var = mags.var(axis=-1)
    var_f = forward_median(mags, MEDIAN_K).var(axis=-1)
    spectrum = np.abs(np.fft.fftshift(fwd, axes=-1))
    top = min(FFT_PEAKS, spectrum.shape[-1])
    order = np.argpartition(-spectrum, top - 1, axis=-1)[:, :top]
    values = np.take_along_axis(spectrum, order, -1)
    by = np.argsort(-values, axis=-1, kind="stable")
    order, values = np.take_along_axis(order, by, -1), np.take_along_axis(values, by, -1)
    is_fsk = ((np.abs(order - order[:, :1]) >= FFT_PEAK_DISTANCE)
              & (values >= FFT_PEAK_POWER)).any(-1)
    b = len(rows)
    out = []
    for i in range(b):
        v = (var[i], var[b + i], var_f[i], var_f[b + i])
        if max(v) < OOK_VARIANCE_CEILING:
            out.append("OOK")
        elif v[0] > ASK_RATIO * v[1]:
            out.append("ASK")
        elif v[0] > PSK_RATIO * v[2]:
            out.append("PSK")
        else:
            out.append("FSK" if is_fsk[i] else "OOK")
    return out


def modulation(iq: np.ndarray, segs: list):
    """The most common decision over the first 100 segments (None: none)."""
    decisions = [None] * len(segs[:MAX_CLASSIFIED])
    buckets = {}
    for i, (a, b) in enumerate(segs[:MAX_CLASSIFIED]):
        f = iq[a:b].astype(np.float32)
        s = f[:, 0] + 1j * f[:, 1]
        dead = np.flatnonzero(np.abs(s) == 0)
        alive = len(s) - len(dead)
        if alive == 0:
            continue
        if len(dead) > OOK_MAX_ZEROS:
            decisions[i] = "OOK"
            continue
        width = 2 ** int(math.log2(alive))
        if width <= 4 * WAVELET_SCALE:
            continue
        live = np.delete(s, dead) if len(dead) else s
        buckets.setdefault(width, []).append((i, live[:width]))
    for members in buckets.values():
        for (i, _), d in zip(members, classify(np.stack([r for _, r in members]))):
            decisions[i] = d
    found = [d for d in decisions if d is not None]
    if not found:
        return None
    counts = Counter(found)
    return max(found, key=counts.get)


# float32 demodulated values that differ by a few ulps between arctangents,
# and bin edges that move with them, put a value near an edge on either side
EDGE_ULPS = 8
# the same roundings move a message's variance, the histogram's bin width,
# by a float32 ulp: its edges then move by as many ulps as they lie bins out
STEP_ULPS = (-1, 1)
# messages whose result such a rounding changes, taken together; beyond
# this many, one at a time
MAX_TOGETHER = 4


def center_of(rect: np.ndarray, band: bool = False, step_ulps: int = 0):
    """The mean of the two dominant histogram levels (bins as wide as the
    values' variance, moved by ``step_ulps`` float32 ulps, the outer 5%
    dropped), or None.  With ``band``, (center, lowest, highest): the
    centers again with every value moved by EDGE_ULPS ulps of the range
    down and up (within the range) against the same edges, the centers a
    rounding of the values can give."""
    r = rect[rect > -4]
    r = r[int(0.05 * len(r)):int(0.95 * len(r))]
    if len(r) == 0:
        return None
    var = np.float32(np.var(r))
    lo, hi = float(np.min(r)), float(np.max(r))
    step = float(var + np.float32(step_ulps) * np.spacing(var))
    try:
        edges = np.arange(lo, hi + step, step)
        if len(edges) <= 1:
            return None if not band else (None, None, None)
    except (ZeroDivisionError, ValueError, MemoryError):
        return None if not band else (None, None, None)

    def dominant(values):
        counts = np.histogram(values, edges)[0]
        reach = max(2, int(0.05 * len(counts)) + 1)
        found = []
        for i in np.argsort(counts)[::-1]:
            v = counts[i]
            if v <= 0:
                continue
            if (v > counts[max(0, i - reach + 1):i]).all() and (v > counts[i + 1:i + reach]).all():
                found.append(edges[i])
            if len(found) == 2:
                break
        return np.mean(found) if found else None

    center = dominant(r)
    if not band:
        return center
    nudge = EDGE_ULPS * float(np.spacing(np.float32(max(abs(lo), abs(hi)))))
    # the extremes stay where they are: they set the edges
    others = [c for c in (dominant(np.clip(r - nudge, lo, hi)), dominant(np.clip(r + nudge, lo, hi)),
                          center) if c is not None]
    return center, min(others, default=None), max(others, default=None)


def plateaus(rect: np.ndarray, center: float, percentage: int = 25) -> np.ndarray:
    n = len(rect)
    above = rect > center
    change = np.flatnonzero(above[1:] != above[:-1]) + 1
    lens = np.diff(np.concatenate(([0], change, [n]))).astype(np.uint64)[:-1]
    if len(lens) == 0:
        return lens
    reached = np.flatnonzero(np.cumsum(lens) >= percentage * n // 100)
    return lens[:reached[0] + 1] if len(reached) else lens


def tolerance_of(lens: np.ndarray, relative_max: float = 0.05):
    if len(lens) <= 1:
        return None
    unique = np.unique(lens)
    limit = relative_max * np.max(without_outliers(unique, 2))
    if unique[0] > 1 and unique[0] >= limit:
        return 0
    zone = unique[:np.searchsorted(unique, max(2.0, limit), side="left")]
    return int(zone[-1]) if len(zone) else 0


def merge_glitches(lens: np.ndarray, tolerance: int, max_count: int = 10000) -> np.ndarray:
    n = len(lens)
    if n == 0 or not tolerance:
        return lens
    out = np.empty(n, np.uint64)
    out[0] = 0 if lens[0] <= tolerance else lens[0]
    cur, i = 0, 1
    while i < n and cur < max_count:
        if lens[i] <= tolerance:
            j = 2
            while i + j < n and lens[i + j] <= tolerance:
                j += 2
            out[cur] = lens[i - 1:min(n, i + j)].sum()
            i += j
        else:
            cur += 1
            out[cur] = lens[i]
            i += 1
    return out[:cur + 1]


def divisor_votes(lens: np.ndarray, threshold: float = 0.2) -> np.ndarray:
    p = np.asarray(lens, np.uint64)
    hist = np.zeros(int(p.max()) + 1, np.uint64)
    unique, counts = np.unique(p, return_counts=True)
    unique, counts = unique[unique != 0], counts[unique != 0]
    if len(unique) == 0:
        return hist
    hist[unique.astype(np.int64)] += (counts * (counts - 1) // 2).astype(np.uint64)
    u = unique.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = u[None, :] / u[:, None] - (unique[None, :] // unique[:, None]).astype(np.float64)
    iu = np.triu_indices(len(unique), k=1)
    hit = frac[iu] < threshold
    np.add.at(hist, unique[iu[0]][hit].astype(np.int64),
              (counts[iu[0]] * counts[iu[1]])[hit].astype(np.uint64))
    return hist


def most_frequent(values: list):
    """Of the values tied for the highest count, the one that appeared last
    to first appear (URH's loop over Counter.most_common)."""
    if not values:
        return None
    ranked = Counter(values).most_common()
    top = ranked[0][1]
    return [v for v, c in ranked if c == top][-1]


def bit_length_of(merged: np.ndarray) -> int:
    if len(merged) == 0:
        return 0
    if len(merged) == 1:
        return int(merged[0])
    lens = np.array(merged, np.uint64)
    digits = min(3, int(np.percentile([len(str(p)) for p in lens], 50)))
    unit = 10 ** (digits - 1)
    lens[:] = [int(round(p / unit)) * unit for p in lens]
    votes = divisor_votes(lens)
    by_vote = np.argsort(votes)[::-1]
    winner = by_vote[0]
    for c in by_vote[1:]:
        if votes[c] < 0.25 * votes[winner]:
            break
        if c <= 0.5 * winner:
            winner = c
    return int(winner)


def message_parameters(rect: np.ndarray, band: list = None, step_ulps: int = 0) -> tuple:
    """(center, bit length, tolerance) of one message; ``band``, a list,
    receives the (lowest, highest) center a rounding can give."""
    found = center_of(rect, band=band is not None, step_ulps=step_ulps)
    center = found[0] if band is not None else found
    if center is None:
        return None, None, None
    if band is not None:
        band.append(found[1:])
    lens = plateaus(rect, center)
    tol = tolerance_of(lens)
    merged = merge_glitches(lens, tol or 0)
    if len(merged) < 2:
        return None, None, tol
    bl = bit_length_of(merged)
    if bl <= (tol or 0) + 1:
        return None, None, tol
    return center, bl, tol


def estimate(x: np.ndarray, rounding=None, keep=None):
    """A capture ((n, 2), its SDR dtype) -> {modulation, samples_per_symbol,
    center, tolerance, noise}, or None where URH's rules decide nothing.
    ``rounding`` lowers the precision of the demodulation (the controls);
    ``keep``, a dict, receives the demodulated capture."""
    xr = x if rounding is None else rounding(np.asarray(x, np.float32))
    mags = magnitudes(xr)
    noise = noise_level(mags)
    segs = segments(mags, noise)
    mod = modulation(xr, segs)
    if mod is None:
        return None
    if mod == "OOK":
        segs = merge_ook(segs)
    kind = "ASK" if mod in ("OOK", "ASK") else mod
    if kind not in ("ASK", "FSK"):
        raise ValueError(f"the reference estimates ASK, OOK or FSK, not {kind}")
    rect = demod.rectangular(x, noise, kind, rounding=rounding)
    if keep is not None:
        keep["rect"] = rect
    outcomes = [message_outcomes(rect[a:b]) for a, b in segs]
    base = combine(kind, [o[0] for o in outcomes])
    if base is None:
        return None
    fragile = [i for i, o in enumerate(outcomes) if len(o) > 1]
    if len(fragile) <= MAX_TOGETHER:
        choices = itertools.product(*[range(len(outcomes[i])) for i in fragile])
    else:
        choices = ([int(i == j) * (k + 1) for i in fragile]
                   for j in fragile for k in range(len(outcomes[j]) - 1))
    candidates = [base]
    for choice in choices:
        picked = [o[0] for o in outcomes]
        for i, k in zip(fragile, choice):
            picked[i] = outcomes[i][k]
        c = combine(kind, picked)
        if c is not None and c not in candidates:
            candidates.append(c)
    return dict(base, modulation=kind, noise=float(noise), candidates=candidates)


def message_outcomes(rect: np.ndarray) -> list:
    """The results a rounding of one message's values can give it: [(center,
    bit length, tolerance, (lowest, highest) center)], the reference's own
    first, then each other (center found or not, bit length, tolerance)
    with the variance moved by STEP_ULPS."""
    out = []
    for u in (0, *STEP_ULPS):
        band = []
        c, bl, t = message_parameters(rect, band, u)
        found = (c is None, bl, t)
        same = [k for k, o in enumerate(out) if (o[0] is None, o[1], o[2]) == found]
        if not same:
            out.append((c, bl, t, band[0] if band else None))
        elif c is not None:
            k = same[0]
            lo, hi = out[k][3]
            out[k] = out[k][:3] + ((min(lo, c, band[0][0]), max(hi, c, band[0][1])),)
    return out


def combine(kind: str, results: list):
    """The votes over the messages' (center, bit length, tolerance, band) ->
    {samples_per_symbol, center, center_band, tolerance}, or None."""
    tols = [t for _, _, t, _ in results if t is not None]
    found = [(c, bl, band) for c, bl, _, band in results if c is not None]
    if not found:
        return None

    def vote(values):
        if kind == "ASK":
            return float(np.min(without_outliers(np.array(values), 2)))
        return float(np.mean(values))

    center = vote([c for c, _, _ in found])
    ends = (vote([b[0] for _, _, b in found]), vote([b[1] for _, _, b in found]), center)
    bl = most_frequent([bl for _, bl, _ in found])
    if bl is None:
        return None
    tol = int(np.percentile(tols, 50)) if tols else max(1, int(0.05 * bl))
    return {"samples_per_symbol": int(bl), "center": center,
            "center_band": (min(ends), max(ends)), "tolerance": tol}


# a Signal's parameters before any are set (urh's Signal defaults)
DEFAULTS = {"modulation": "FSK", "samples_per_symbol": 100, "center": 0.0, "tolerance": 5,
            "noise": 0.0}


def analyze(x: np.ndarray, rounding=None):
    """estimate, then demodulate at the estimated parameters -> (params or
    None, demod.demodulate's result).  Where the estimate decides nothing the
    signal keeps its defaults and is demodulated at them."""
    keep = {}
    params = estimate(x, rounding=rounding, keep=keep)
    at = dict(params or DEFAULTS, pause_threshold=8)
    rect = keep.get("rect") if params is not None and params["modulation"] == at["modulation"] else None
    return params, demod.demodulate(x, at, rounding=rounding, rect=rect)
