"""Plain channel isolation of a band's capture: URH's "apply bandpass
filter" (urh/signalprocessing/Filter.py) written out again in float64, then
URH's auto-detection at the modulation the user set (FSK) over the filtered
samples, and the demodulation at what it finds.

The filter: a windowed sinc of N = ceil(4 / bw) taps (made odd) at the
band's half width, times a Blackman window, normalized to a unit sum and
shifted to the band's center; the capture's samples as complex (int8 over
128, as the program's IQData converts them; float32 as they are); the
convolution by FFT over the full length, trimmed to the input's length,
centred (Filter.py's fft_convolve_1d, whose centring np.convolve's "same"
shares).  The analysis: the noise floor, the segmentation, the per-message
parameters with the outcomes a rounding can give and the votes are
:mod:`benchmark.reference.estimate`'s, the demodulation
:mod:`benchmark.reference.demod`'s; with the modulation given, nothing is
classified and no segments are merged.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference import demod, psk
from benchmark.reference import estimate as ref


def taps(f_low: float, f_high: float, bw: float) -> np.ndarray:
    """The band-pass filter's complex128 taps for normalized band edges
    (swapped where reversed, clipped to [-0.5, 0.5]) and a transition width."""
    f_low, f_high = sorted((f_low, f_high))
    f_low, f_high = min(max(f_low, -0.5), 0.5), min(max(f_high, -0.5), 0.5)
    n = int(math.ceil(4 / bw))
    n += 1 - n % 2
    k = np.arange(n, dtype=np.float64)
    h = np.sinc((f_high - f_low) * (k - (n - 1) / 2))
    h *= 0.42 - 0.5 * np.cos(2 * np.pi * k / (n - 1)) + 0.08 * np.cos(4 * np.pi * k / (n - 1))
    h /= h.sum()
    return h * np.exp(2j * np.pi * (f_low + f_high) / 2 * k)


def as_complex(x: np.ndarray) -> np.ndarray:
    """(n, 2) samples -> complex128 in the program's units: int8 over 128,
    float32 as they are."""
    f = np.asarray(x, np.float64)
    if np.asarray(x).dtype == np.int8:
        f = f / 128.0
    return f[:, 0] + 1j * f[:, 1]


def _complex_rounded(y: np.ndarray, rounding) -> np.ndarray:
    re = rounding(np.ascontiguousarray(y.real, np.float32)).astype(np.float64)
    im = rounding(np.ascontiguousarray(y.imag, np.float32)).astype(np.float64)
    return re + 1j * im


def bandpass(x: np.ndarray, f_low: float, f_high: float, bw: float, rounding=None) -> np.ndarray:
    """The capture band-pass filtered -> complex128 of its length.
    ``rounding`` (the control's lower precision) rounds the samples, the
    taps and the output; the arithmetic stays float64."""
    s, h = as_complex(x), taps(f_low, f_high, bw)
    if rounding is not None:
        s, h = _complex_rounded(s, rounding), _complex_rounded(h, rounding)
    n_full = len(s) + len(h) - 1
    n_fft = 1 << (n_full - 1).bit_length()
    full = np.fft.ifft(np.fft.fft(s, n_fft) * np.fft.fft(h, n_fft))[:n_full]
    cut = (n_full - len(s)) // 2
    out = full[cut:cut + len(s)]
    return out if rounding is None else _complex_rounded(out, rounding)


def planes(y: np.ndarray) -> np.ndarray:
    """Complex samples -> the (n, 2) float32 planes a filtered signal holds."""
    out = np.empty((len(y), 2), np.float32)
    out[:, 0], out[:, 1] = y.real, y.imag
    return out


def error(got: np.ndarray, want: np.ndarray) -> float:
    """The largest gap between two filtered captures (complex, or float
    planes), relative to the largest magnitude of ``want``."""
    g = got if np.iscomplexobj(got) else as_complex(got)
    w = want if np.iscomplexobj(want) else as_complex(want)
    return float(np.max(np.abs(g - w)) / np.max(np.abs(w)))


def estimate(x: np.ndarray, modulation: str = "FSK", rounding=None, keep=None):
    """Filtered float32 planes -> {modulation, samples_per_symbol, center,
    center_band, tolerance, noise, candidates}, or None where URH's rules
    decide nothing, at the modulation given.  ``rounding`` lowers the
    precision of the demodulation (the control); ``keep``, a dict, receives
    the demodulated capture."""
    xr = x if rounding is None else rounding(np.asarray(x, np.float32))
    mags = ref.magnitudes(xr)
    noise = ref.noise_level(mags)
    segs = ref.segments(mags, noise)
    rect = demod.rectangular(x, noise, modulation, rounding=rounding)
    if keep is not None:
        keep["rect"] = rect
    # the votes are PSK's and FSK's alike (only ASK's differ)
    base, found = psk.candidates([ref.message_outcomes(rect[a:b]) for a, b in segs])
    if base is None:
        return None
    return dict(base, modulation=modulation, noise=float(noise), candidates=found)


def analyze(x: np.ndarray, modulation: str = "FSK", rounding=None):
    """estimate, then demodulate at the estimated parameters -> (params or
    None, demod.demodulate's result).  Where the estimate decides nothing
    the signal keeps its defaults (noise 0 included) and is demodulated at
    them."""
    keep = {}
    params = estimate(x, modulation, rounding=rounding, keep=keep)
    at = dict(params or dict(ref.DEFAULTS, modulation=modulation), pause_threshold=8)
    rect = keep["rect"] if params is not None else None
    return params, demod.demodulate(x, at, rounding=rounding, rect=rect)
