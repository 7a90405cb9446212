"""FIR/IIR filtering and filter design (PyTorch port of urh_tpu.dsp.filters).

Counterpart of urh/signalprocessing/Filter.py and the convolution
kernels in urh/cythonext/signal_functions.pyx:513-542.  Convolution runs
on the device as FFTs (``torch.fft``): one full-length FFT product for
short inputs, overlap-save blocks (frames by ``unfold``) for long ones,
with urh_tpu's route and block sizes.  The IIR filter's feed-forward sum
stays on the host (urh_tpu's NumPy code, the same bits); its sequential
feedback runs as the CUDA kernel B8 (:mod:`urh_tpu_torch.dsp.iir_kernels`).
Filter design (windowed sinc, blackman) is tiny host math.

Every function that computes on a device takes ``device`` (default: the
CUDA card, RuntimeError without one; ``device="cpu"`` runs torch's CPU
ops and the plain versions) and returns NumPy arrays, as urh_tpu's do.
"""

from __future__ import annotations

import math
from enum import Enum

import numpy as np
import torch

from urh_tpu_torch.core.iq import resolve_device
from urh_tpu_torch.core.xfer import to_host
from urh_tpu_torch.dsp import iir_kernels
from urh_tpu_torch.util.metrics import metrics


class FilterType(Enum):
    moving_average = "moving average"
    dc_correction = "DC correction"
    custom = "custom"


def _fft_full_convolve(x: torch.Tensor, h: torch.Tensor, n_out: int) -> torch.Tensor:
    """Full linear convolution via FFT, truncated to n_out samples."""
    n = x.shape[0] + h.shape[0] - 1
    n_fft = 1 << (n - 1).bit_length()
    return torch.fft.ifft(torch.fft.fft(x, n_fft) * torch.fft.fft(h, n_fft), n_fft)[:n_out]


def _overlap_save_convolve(x: torch.Tensor, h: torch.Tensor, block: int, m: int):
    """Overlap-save FFT convolution: x (N,) complex64, h (m,) taps.

    Returns the 'full' convolution truncated to N samples (the
    reference fir_filter semantics, signal_functions.pyx:513-525).  Frame b
    is padded[b * step : b * step + block], a strided view (``unfold``) of
    the padded input, as urh_tpu's halo + body frames are.
    """
    n = x.shape[0]
    step = block - (m - 1)
    n_blocks = -(-n // step)
    # left halo of m-1 zeros, pad to block structure
    padded = torch.cat([x.new_zeros(m - 1), x, x.new_zeros(n_blocks * step - n + block)])
    frames = padded.unfold(0, block, step)[:n_blocks]
    spectrum = torch.fft.fft(h, block)
    out = torch.fft.ifft(torch.fft.fft(frames, dim=1) * spectrum[None, :], dim=1)
    return out[:, m - 1:].reshape(-1)[:n]  # valid part of each block


def _to_device(values, device) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values.to(resolve_device(device), torch.complex64)
    return torch.from_numpy(np.ascontiguousarray(values, dtype=np.complex64)).to(
        resolve_device(device))


def _is_complex(values) -> bool:
    if isinstance(values, torch.Tensor):
        return values.is_complex()
    return np.issubdtype(np.asarray(values).dtype, np.complexfloating)


def fir_filter(input_samples: np.ndarray, filter_taps: np.ndarray, device=None) -> np.ndarray:
    """Complex FIR filter on ``device``; output length == input length."""
    x = _to_device(input_samples, device)
    h = _to_device(filter_taps, x.device)
    m = int(h.shape[0])
    n = int(x.shape[0])
    if n == 0:
        return np.zeros(0, dtype=np.complex64)
    if m >= n or n < 4096:
        out = _fft_full_convolve(x, h, n)
    else:
        block = max(4096, 1 << (2 * m - 1).bit_length())
        if block >= n:
            out = _fft_full_convolve(x, h, n)
        else:
            out = _overlap_save_convolve(x, h, block, m)
    return out.cpu().numpy().astype(np.complex64)


def iir_filter(a: np.ndarray, b: np.ndarray, signal: np.ndarray, device=None) -> np.ndarray:
    """Direct-form IIR (signal_functions.pyx:527-542): y[n] = sum_j a[j] x[n-j]
    + sum_k b[k] y[n-1-k] from n = max(len(a), len(b) + 1) on, zero before;
    the feedback runs as the B8 kernel on ``device``."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    signal = np.asarray(signal, dtype=np.complex64)
    M, N = len(a), len(b)
    start = max(M, N + 1)
    n_total = len(signal)
    if n_total <= start:
        return np.zeros(n_total, dtype=np.complex64)

    result = np.zeros(n_total, dtype=np.complex64)
    # feed-forward part is a correlation -> vectorized (urh_tpu's host sum)
    ff = np.zeros(n_total, dtype=np.complex64)
    for j in range(M):
        ff[start:] += a[j] * signal[start - j : n_total - j]

    # feedback is sequential over samples with a carry of the last N
    # outputs; b is real, so the taps stay float32
    device = resolve_device(device)
    planes = torch.from_numpy(ff[start:].view(np.float32).reshape(-1, 2)).to(device)
    taps = torch.from_numpy(b[::-1].astype(np.float32)).to(device)
    out = iir_kernels.iir_feedback(planes, taps)
    result[start:] = out.cpu().numpy().reshape(-1).view(np.complex64)
    return result


class Filter:
    BANDWIDTHS = {
        "Very Narrow": 0.001,
        "Narrow": 0.01,
        "Medium": 0.08,
        "Wide": 0.1,
        "Very Wide": 0.42,
    }

    def __init__(self, taps: list, filter_type: FilterType = FilterType.custom):
        self.filter_type = filter_type
        self.taps = taps

    def work(self, input_signal: np.ndarray, device=None) -> np.ndarray:
        if self.filter_type == FilterType.dc_correction:
            return input_signal - np.mean(input_signal, axis=0)
        return self.apply_fir_filter(np.asarray(input_signal).flatten(), device)

    def apply_fir_filter(self, input_signal: np.ndarray, device=None) -> np.ndarray:
        if input_signal.dtype != np.complex64:
            tmp = np.empty(len(input_signal) // 2, dtype=np.complex64)
            tmp.real = input_signal[0::2]
            tmp.imag = input_signal[1::2]
            input_signal = tmp
        return fir_filter(input_signal, np.array(self.taps, dtype=np.complex64), device)

    @staticmethod
    def read_configured_filter_bw() -> float:
        from urh_tpu_torch.util import settings

        bw_type = settings.read("bandpass_filter_bw_type", "Medium", str)
        if bw_type in Filter.BANDWIDTHS:
            return Filter.BANDWIDTHS[bw_type]
        if bw_type.lower() == "custom":
            return settings.read("bandpass_filter_custom_bw", 0.1, float)
        return 0.08

    @staticmethod
    def get_bandwidth_from_filter_length(N):
        return 4 / N

    @staticmethod
    def get_filter_length_from_bandwidth(bw):
        N = int(math.ceil(4 / bw))
        return N + 1 if N % 2 == 0 else N  # ensure odd length

    @staticmethod
    def fft_convolve_1d(x, h: np.ndarray, device=None) -> np.ndarray:
        """Centered FFT convolution (Filter.py:69-82 semantics) on ``device``;
        ``x`` is a NumPy array or a tensor (on ``device`` already, say).
        The centered part alone comes back to the host."""
        n = len(x) + len(h) - 1
        xd = _to_device(x, device)
        out = _fft_full_convolve(xd, _to_device(h, xd.device), n)
        too_much = (n - len(x)) // 2
        out = to_host(out[too_much : n - too_much])
        if not (_is_complex(x) or _is_complex(h)):
            out = out.real
        return out

    @staticmethod
    def apply_bandpass_filter(data, f_low, f_high, filter_bw=0.08, device=None):
        if f_low > f_high:
            f_low, f_high = f_high, f_low
        f_low = max(-0.5, min(f_low, 0.5))
        f_high = max(-0.5, min(f_high, 0.5))

        h = Filter.design_windowed_sinc_bandpass(f_low, f_high, filter_bw)
        route = Filter.convolution_route(len(data), len(h))
        with metrics.span("filter.convolve", samples=len(data), taps=len(h), route=route):
            out = np.convolve(data, h, "same") if route == "host" \
                else Filter.fft_convolve_1d(data, h, device)
        metrics.count({"filter.samples": len(data), f"filter.{route}": 1})
        return out

    @staticmethod
    def convolution_route(n_samples: int, n_taps: int) -> str:
        """Where :meth:`apply_bandpass_filter` convolves: "host" (np.convolve)
        below the reference's tap-count heuristic (urh_tpu's, kept), else
        "card" (:meth:`fft_convolve_1d` on the device, the CPU for a CPU
        device)."""
        return "host" if n_taps < 8 * math.log(math.sqrt(n_samples)) else "card"

    @staticmethod
    def design_windowed_sinc_lpf(fc, bw) -> np.ndarray:
        N = Filter.get_filter_length_from_bandwidth(bw)
        h = np.sinc(2 * fc * (np.arange(N) - (N - 1) / 2.0))
        w = np.blackman(N)
        h = h * w
        return h / np.sum(h)

    @staticmethod
    def design_windowed_sinc_bandpass(f_low, f_high, bw) -> np.ndarray:
        f_shift = (f_low + f_high) / 2
        f_c = (f_high - f_low) / 2
        N = Filter.get_filter_length_from_bandwidth(bw)
        return Filter.design_windowed_sinc_lpf(f_c, bw=bw) * np.exp(
            complex(0, 1) * np.pi * 2 * f_shift * np.arange(0, N, dtype=complex)
        )
