"""Quadrature demodulation (PyTorch port of urh_tpu.dsp.demod).

Behavioral equivalent of the reference's amplitude/frequency/phase
demodulator (urh/cythonext/signal_functions.pyx:252-378).  ASK and FSK
are elementwise and run as plain PyTorch ops on the capture's device.  PSK
carrier recovery (the Costas loop, a sequential feedback recursion) runs
as a CUDA kernel (:mod:`urh_tpu_torch.dsp.costas`).  OQPSK takes the
quadrature discriminator, as urh_tpu's host route does.

Noise handling matches the reference: samples whose squared magnitude is
at or below the squared noise threshold produce a modulation-dependent
sentinel (0.0 for ASK, -4.0 for FSK/PSK, signal_functions.pyx:31-44) which
the symbolizer maps to pause.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from urh_tpu_torch.core.iq import max_magnitude_for_dtype, normalize_scale_shift
from urh_tpu_torch.util import placement

# under device="auto", fewer samples (scaled by the dispatch cost) go to the CPU
DEVICE_MIN_DEMOD_SAMPLES = 1 << 16

NOISE_FSK_PSK = -4.0
NOISE_ASK = 0.0

_NUMPY_DTYPES = {torch.int8: np.int8, torch.uint8: np.uint8, torch.int16: np.int16,
                 torch.uint16: np.uint16, torch.float32: np.float32}


def noise_sentinel(mod_type: str) -> float:
    """Sentinel written for sub-noise samples (signal_functions.pyx:34-44)."""
    if mod_type == "ASK":
        return NOISE_ASK
    if mod_type in ("FSK", "PSK", "OQPSK"):
        return NOISE_FSK_PSK
    if mod_type == "QAM":
        return NOISE_ASK * NOISE_FSK_PSK
    return 0.0


@dataclass
class DemodParams:
    """Demodulation parameter set (mirrors Signal's parameter state,
    urh/signalprocessing/Signal.py:52-83)."""

    modulation: str = "FSK"
    samples_per_symbol: int = 100
    center: float = 0.0
    center_spacing: float = 1.0
    noise_threshold: float = 0.0
    tolerance: int = 5
    bits_per_symbol: int = 1
    pause_threshold: int = 8
    message_length_divisor: int = 1
    costas_loop_bandwidth: float = 0.1
    sample_rate: float = 1e6

    @property
    def modulation_order(self) -> int:
        return 2 ** self.bits_per_symbol


def sqrt_rn(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as IEEE sqrtf, np.sqrt and the CUDA
    kernels give it.  PyTorch's vectorized CPU sqrt may be an ulp off;
    the float64 sqrt of a float32 value rounds to the exact float32 one."""
    return torch.sqrt(v.double()).float()


def scalar_f32(v: float, device) -> torch.Tensor:
    """0-dim float32 tensor: comparisons and divisions then use the
    float32-rounded scalar, as the CUDA kernels do (a Python float divisor
    would let CUDA PyTorch multiply by its reciprocal instead)."""
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def prev_sample(v: torch.Tensor) -> torch.Tensor:
    """v[i-1], with v[-1] := v[0]."""
    return torch.cat((v[:1], v[:-1]))


def afp_demod_vec(x: torch.Tensor, noise_sqrd: float, max_mag: float,
                  mod_type: str) -> torch.Tensor:
    """x: (N, 2) float32 raw-unit samples -> (N,) float32 demodulated
    (urh_tpu's _afp_demod_vec; max_mag is used by ASK only)."""
    re = x[:, 0]
    im = x[:, 1]
    mag2 = re * re + im * im
    sentinel = noise_sentinel(mod_type)

    if mod_type == "ASK":
        val = sqrt_rn(mag2) / scalar_f32(max_mag, x.device)
    elif mod_type == "FSK":
        # quadrature discriminator: arg(conj(x[n-1]) * x[n])
        prev_re, prev_im = prev_sample(re), prev_sample(im)
        t_re = prev_re * re + prev_im * im
        t_im = prev_re * im - prev_im * re
        val = torch.atan2(t_im, t_re)
    else:
        raise ValueError(f"vectorized demod does not support {mod_type}")

    out = val.masked_fill(mag2 <= scalar_f32(noise_sqrd, x.device), sentinel)
    out[:1] = sentinel
    return out


def afp_demod(
    samples,
    noise_mag: float,
    mod_type: str,
    mod_order: int = 2,
    costas_loop_bandwidth: float = 0.1,
    dtype=None,
    device=None,
) -> torch.Tensor:
    """Demodulate raw IQ into a rectangular (quadrature-demodulated) signal.

    ``samples``: (N, 2) numpy array or tensor in any ingest dtype, raw
    units.  A tensor is demodulated on its own device; numpy goes to
    ``device`` (default: the CUDA card).  Under ``"auto"`` urh_tpu's rule
    places numpy that is not PSK: the card from DEVICE_MIN_DEMOD_SAMPLES
    samples while the I/O cost (8 B a sample up, 4 back) stays within 2 ns
    a sample, else the CPU.  ``dtype`` overrides the dtype
    used for scale constants (defaults to the samples').  Semantics of
    signal_functions.pyx:333-378.  ``mod_order`` and
    ``costas_loop_bandwidth`` are the Costas loop's, for PSK.  OQPSK
    takes the quadrature discriminator (urh_tpu's host route,
    ``_afp_demod_np``, does the same).
    """
    if isinstance(samples, torch.Tensor):
        x = samples
        src_dtype = _NUMPY_DTYPES[x.dtype]
    else:
        samples = np.asarray(samples)
        src_dtype = samples.dtype
        n = len(samples)
        if mod_type == "PSK":  # urh_tpu runs every PSK capture on its device
            dev = placement.place(device)[0]
        else:
            dev, _ = placement.choose(
                "dsp.afp_demod", device,
                lambda: n >= placement.scaled_threshold(DEVICE_MIN_DEMOD_SAMPLES)
                and placement.device_io_cost_s(8 * n, 4 * n) <= n * 2e-9)
        x = torch.from_numpy(np.ascontiguousarray(samples)).to(dev)
    dtype = np.dtype(dtype) if dtype is not None else np.dtype(src_dtype)
    n = len(x)
    if n <= 2:
        return torch.zeros(n, dtype=torch.float32, device=x.device)

    noise_sqrd = float(np.float32(noise_mag * noise_mag))
    x = x.to(torch.float32)
    if mod_type == "PSK":
        from urh_tpu_torch.dsp import costas  # costas imports this module

        scale, shift = normalize_scale_shift(dtype)
        # the loop starts at sample 1 (signal_functions.pyx:289); sample 0
        # gets the noise sentinel, as urh_tpu writes it
        qad = torch.empty(n, dtype=torch.float32, device=x.device)
        qad[0] = NOISE_FSK_PSK
        qad[1:] = costas.costa_demod_scan(x[1:], noise_sqrd, scale, shift, int(mod_order),
                                          costas_loop_bandwidth, costas.new_carry(x.device))
        return qad
    return afp_demod_vec(x, noise_sqrd, max_magnitude_for_dtype(dtype),
                         "FSK" if mod_type == "OQPSK" else mod_type)
