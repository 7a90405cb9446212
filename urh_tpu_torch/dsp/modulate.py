"""Modulation synthesis (PyTorch port of urh_tpu.dsp.modulate).

Equivalent of the reference's per-symbol synthesis loop
(urh/cythonext/signal_functions.pyx:56-243):

* per-symbol work (bit grouping, OQPSK staggering, the FSK phase
  corrections, the GFSK Gaussian filter taps) is host NumPy, as urh_tpu
  does it;
* the per-sample synthesis (``_synthesize``, ``_carrier``) and GFSK's
  frequency smoothing and phase steps are torch ops on the given device
  (default: the CUDA card), in float32 with the operation order of
  urh_tpu's host route, ``arg = ((t * f) * 2pi) + phi``, each op rounded
  on its own (XLA on the CPU contracts the last two into an FMA, so
  urh_tpu's device route, from 2^21 samples on, is an ulp of ``arg`` away
  from its own host route).  Every scalar is a 0-dim float32
  tensor on the device: a Python-float divisor would let CUDA PyTorch
  multiply by its reciprocal, and ``t`` would no longer be urh_tpu's.

The synthesis runs on the given device; under ``device="auto"`` a body
below urh_tpu's DEVICE_MIN_BODY_SAMPLES synthesizes on the CPU and a
larger one on the card, as urh_tpu chooses between its host twin and its
device route.  A sample then differs from urh_tpu's host route only by
the cosine and sine implementations, a few float32 ulps; GFSK's smoothed
frequencies are also an ulp or two from np.convolve's float32 sums.  The
ThreadPoolExecutor carrier pool of urh_tpu's host twin is not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from urh_tpu_torch.dsp.demod import scalar_f32
from urh_tpu_torch.util import placement

# under device="auto", a body of fewer samples synthesizes on the CPU
DEVICE_MIN_BODY_SAMPLES = 1 << 21

# output types cast on the device (the Modulator's); others on the host
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int8): torch.int8,
                 np.dtype(np.int16): torch.int16}


def bits_to_symbol_indices(bits: np.ndarray, bits_per_symbol: int) -> np.ndarray:
    """MSB-first bit groups -> symbol indices."""
    bits = np.asarray(bits, dtype=np.uint8)
    total_symbols = len(bits) // bits_per_symbol
    grouped = bits[: total_symbols * bits_per_symbol].reshape(total_symbols, bits_per_symbol)
    powers = 2 ** np.arange(bits_per_symbol - 1, -1, -1, dtype=np.int64)
    return grouped.astype(np.int64) @ powers


def get_oqpsk_bits(original_bits: np.ndarray) -> np.ndarray:
    """Offset-QPSK bit staggering (signal_functions.pyx:179-193).

    (The reference marks this as known-imperfect; replicated for parity.)
    """
    bits = np.asarray(original_bits, dtype=np.uint8)
    num_bits = len(bits)
    if num_bits == 0:
        return np.zeros(0, dtype=np.uint8)
    result = np.zeros(num_bits + 2, dtype=np.uint8)
    result[0] = bits[0]
    result[num_bits + 1] = bits[num_bits - 1]
    for i in range(2, num_bits - 2, 2):
        result[i] = bits[i]
        result[i + 1] = bits[i - 1]
    return result


def gauss_fir(sample_rate: float, samples_per_symbol: int, bt: float = 0.5,
              filter_width: float = 1.0) -> np.ndarray:
    """Gaussian FIR for GFSK frequency smoothing
    (signal_functions.pyx:228-243)."""
    k = np.arange(
        -int(filter_width * samples_per_symbol),
        int(filter_width * samples_per_symbol) + 1,
        dtype=np.float32,
    )
    ts = samples_per_symbol / sample_rate
    h = (
        np.sqrt((2 * np.pi) / np.log(2)) * bt / ts
        * np.exp(-(((np.sqrt(2) * np.pi) / np.sqrt(np.log(2)) * bt * k / samples_per_symbol) ** 2))
    ).astype(np.float32)
    return h / h.sum()


def _carrier(a: torch.Tensor, f: torch.Tensor, phi: torch.Tensor, start: float,
             sample_rate: float) -> torch.Tensor:
    """Per-sample (amplitude, frequency, phase) -> (n, 2) float32 IQ on
    their device, urh_tpu's _synthesize_per_sample."""
    dev = f.device
    t = (torch.arange(len(f), dtype=torch.float32, device=dev) + scalar_f32(start, dev)
         ) / scalar_f32(sample_rate, dev)
    arg = t * f * scalar_f32(2 * math.pi, dev) + phi
    return torch.stack((a * torch.cos(arg), a * torch.sin(arg)), dim=-1)


def _synthesize(a_sym: np.ndarray, f_sym: np.ndarray, phi_sym: np.ndarray, start: float,
                sample_rate: float, sps: int, device) -> torch.Tensor:
    """Per-symbol (amplitude, frequency, phase + correction) -> (n, 2)
    float32 IQ on ``device``: the per-symbol values cross PCIe, the
    per-sample ones are repeated on the device."""
    a, f, phi = (torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(device)
                 .repeat_interleave(sps) for v in (a_sym, f_sym, phi_sym))
    return _carrier(a, f, phi, start, sample_rate)


def _same_convolve(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """np.convolve(x, taps, "same") for len(x) >= len(taps), else
    np.convolve(taps, x, "same")[:len(x)], for float32 x and taps, as sums
    of shifted products tap by tap in float64, rounded to float32 once.  A
    product of two float32 is exact in float64 and each op rounds on its
    own, so the card and the CPU give the same bits, the correctly rounded
    sum but for a float64 rounding; np.convolve sums in float32, about an
    ulp from it."""
    n, m = len(x), len(taps)
    offset = (min(n, m) - 1) // 2  # where "same" starts in the full product
    x = x.double()
    g = torch.from_numpy(np.asarray(taps, dtype=np.float64)).to(x.device)
    out = torch.zeros_like(x)
    for t in range(m):
        shift = offset - t  # out[i] += x[i + shift] * taps[t]
        lo, hi = max(0, -shift), min(n, n - shift)
        if lo < hi:
            out[lo:hi] += x[lo + shift:hi + shift] * g[t]
    return out.float()


def _gfsk_body(freq_sym: np.ndarray, samples_per_symbol: int, sample_rate: float,
               start: int, carrier_amplitude: float, carrier_phase: float, gauss_bt: float,
               filter_width: float, device) -> torch.Tensor:
    """GFSK: the per-sample frequencies smoothed by the Gaussian filter, the
    phase kept continuous by phases[i+1] = phases[i] + 2*pi*t[i]*(f[i] -
    f[i+1]), then synthesized.  The steps are float64 on the device; their
    running sum is np.cumsum on the host, urh_tpu's sequential float64 sum:
    the phases grow to millions of radians, where a scan that adds in
    another order moves a float32 phase by whole ulps of radians."""
    freqs = torch.from_numpy(np.ascontiguousarray(freq_sym, dtype=np.float32)).to(device)
    freqs = _same_convolve(freqs.repeat_interleave(samples_per_symbol),
                           gauss_fir(sample_rate, samples_per_symbol, bt=gauss_bt,
                                     filter_width=filter_width))
    n = len(freqs)
    t = (torch.arange(start, start + n, device=device).to(torch.float32)
         / scalar_f32(sample_rate, device)).double()
    f64 = freqs.double()
    deltas = (2 * math.pi * t[:-1] * (f64[:-1] - f64[1:])).cpu().numpy()
    phases = carrier_phase + np.concatenate(([0.0], np.cumsum(deltas)))
    phases = torch.from_numpy(phases.astype(np.float32)).to(device)
    amps = torch.full((n,), carrier_amplitude, dtype=torch.float32, device=device)
    return _carrier(amps, freqs, phases, start, sample_rate)


def _fsk_phase_corrections(f_sym: np.ndarray, samples_per_symbol: int,
                           start: int, sample_rate: float) -> np.ndarray:
    """Continuous-phase FSK correction per symbol: cumulative sum of the
    per-transition phase deltas (replaces the sequential table,
    signal_functions.pyx:121-137)."""
    S = len(f_sym)
    if S == 0:
        return np.zeros(0, dtype=np.float64)
    f_prev = np.empty_like(f_sym)
    f_prev[0] = f_sym[0]
    f_prev[1:] = f_sym[:-1]
    s_i = np.arange(S, dtype=np.float64)
    # boundary times as C float to match (s_i*sps+start-1)/sample_rate
    t_b = ((s_i * samples_per_symbol + start - 1).astype(np.float32) / np.float32(sample_rate)).astype(np.float64)
    delta = np.where(f_sym != f_prev, 2 * np.pi * (f_prev.astype(np.float64) - f_sym) * t_b, 0.0)
    delta[0] = 0.0
    return np.mod(np.cumsum(delta), 2 * np.pi)


def modulate(
    bits,
    samples_per_symbol: int,
    modulation_type: str,
    parameters,
    bits_per_symbol: int = 1,
    carrier_amplitude: float = 1.0,
    carrier_frequency: float = 40e3,
    carrier_phase: float = 0.0,
    sample_rate: float = 1e6,
    pause: int = 0,
    start: int = 0,
    dtype=np.float32,
    gauss_bt: float = 0.5,
    filter_width: float = 1.0,
    device=None,
) -> np.ndarray:
    """bits -> (total_samples, 2) IQ numpy array of ``dtype``, synthesized on
    ``device`` (default: the CUDA card; ``"auto"``: the CPU for a body below
    DEVICE_MIN_BODY_SAMPLES, the card from there).

    Semantics of signal_functions.pyx:56-177 (modulate_c/__modulate).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    parameters = np.asarray(parameters, dtype=np.float32)
    dtype = np.dtype(dtype)
    mt = modulation_type.lower()
    if mt not in ("ask", "fsk", "psk", "oqpsk", "gfsk"):
        raise ValueError(f"unknown modulation type {modulation_type}")

    if mt == "oqpsk":
        if bits_per_symbol != 2:
            raise ValueError("OQPSK requires 2 bits per symbol")
        bits = get_oqpsk_bits(bits)

    num_bits = len(bits)
    total_symbols = num_bits // bits_per_symbol
    total_samples = total_symbols * samples_per_symbol + pause
    device, _ = placement.choose("dsp.modulate", device,
                                 lambda: total_symbols * samples_per_symbol
                                 >= DEVICE_MIN_BODY_SAMPLES)
    if num_bits == 0:
        return np.zeros((total_samples, 2), dtype=dtype)

    idx = bits_to_symbol_indices(bits, bits_per_symbol)

    a_sym = np.full(total_symbols, carrier_amplitude, dtype=np.float32)
    f_sym = np.full(total_symbols, carrier_frequency, dtype=np.float32)
    phi_sym = np.full(total_symbols, carrier_phase, dtype=np.float32)

    if mt == "ask":
        a_sym = parameters[idx]
    elif mt == "fsk":
        f_sym = parameters[idx]
        phi_sym = phi_sym + _fsk_phase_corrections(
            f_sym, samples_per_symbol, start, sample_rate
        ).astype(np.float32)
    elif mt in ("psk", "oqpsk"):
        phi_sym = parameters[idx]

    if mt == "gfsk":
        body = _gfsk_body(parameters[idx], samples_per_symbol, sample_rate, start,
                          carrier_amplitude, carrier_phase, gauss_bt, filter_width, device)
    else:
        body = _synthesize(a_sym, f_sym, phi_sym, start, sample_rate,
                           int(samples_per_symbol), device)
    if mt == "oqpsk":
        body[:samples_per_symbol, 1] = 0
        body[len(body) - samples_per_symbol:, 0] = 0

    result = np.zeros((total_samples, 2), dtype=dtype)
    # C-style truncation toward zero, like the reference's <iq> cast, on the
    # device: only the final samples cross PCIe
    if dtype in _TORCH_DTYPES:
        result[: len(body)] = body.to(_TORCH_DTYPES[dtype]).cpu().numpy()
    else:
        result[: len(body)] = body.cpu().numpy().astype(dtype)
    return result
