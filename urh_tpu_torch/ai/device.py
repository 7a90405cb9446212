"""Batched device programs for auto-interpretation (PyTorch port of
urh_tpu.ai.device).

Messages are bucketed by power-of-two length, and each bucket is
classified by one pass on the device computing, for every message at once:

* the FFT-domain Haar CWT (Wavelet.py:7-43 of the reference) of the
  peak-normalized and of the unit-magnitude signal (``torch.fft``);
* the variances of both CWT magnitudes, raw and median-filtered: the
  forward-window median is the B7 kernel
  (:mod:`urh_tpu_torch.ai.median_kernels`), one launch a bucket over the
  two magnitudes stacked;
* the FSK spectral test (a second strong FFT peak far from the main one,
  ``torch.topk``).

Only per-message scalars come back to the host.  Each entry computes on
the device it is given (the CPU runs the same torch ops and B7's plain
version).  Under ``device="auto"`` each is placed as urh_tpu places it
(:mod:`urh_tpu_torch.util.placement`): the card from DEVICE_MIN_CELLS
cells scaled by the measured dispatch cost, and, for the bulk transfers,
only while the measured I/O cost stays below urh_tpu's host cost a cell;
the CPU otherwise.  The decision thresholds live in
:mod:`urh_tpu_torch.ai.estimate`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from urh_tpu_torch.ai.median_kernels import median_filter
from urh_tpu_torch.dsp.demod import scalar_f32
from urh_tpu_torch.native import get_library
from urh_tpu_torch.util import placement

# below this many complex cells a bucket goes to the host under "auto"
DEVICE_MIN_CELLS = 1 << 15
# urh_tpu's host median (_median_full_windows_np): the native library from
# this many cells, its sliding sorted window up to this k
NATIVE_MEDIAN_MIN_CELLS = 1 << 16
NATIVE_MEDIAN_SLIDING_MAX_K = 64

FFT_PEAK_MIN_DISTANCE = 10  # bins between the two strongest peaks
FFT_PEAK_MIN_POWER = 100  # noise amplitude scale
FFT_PEAK_COUNT = 10

# From this many values on, histogram() bins as urh_tpu's device route does
# (float32 arithmetic); below it, it counts as np.histogram does.  urh_tpu
# chose the route by this size; here it is a rule of the result, and under
# "auto" the route too (scaled as urh_tpu scales it).
HISTOGRAM_MIN_VALUES = 1 << 22


def use_device(n_cells: int) -> bool:
    """urh_tpu's size rule for a placed call (needs the card's probe)."""
    return n_cells >= placement.scaled_threshold(DEVICE_MIN_CELLS)


def pow2_floor(n: int) -> int:
    return 2 ** int(math.log2(n)) if n > 0 else 0


# ---------------------------------------------------------------------------
# Haar CWT (FFT domain, Torrence & Compo)
# ---------------------------------------------------------------------------


def _haar_spectrum_np(num_data: int, scale: int) -> np.ndarray:
    f = 2.0 * np.pi / num_data
    omega = f * np.concatenate(
        (np.arange(0, num_data // 2), np.arange(num_data // 2, num_data) * -1))
    scaled = scale * omega
    safe = scaled / scale
    safe[0] = 1.0
    wavelet = (1j * np.square(-1 + np.exp(0.5j * scaled))) / safe
    return np.sqrt(2.0 * np.pi * scale) * wavelet


def cwt_haar(x: torch.Tensor, scale: int = 10, fwd: torch.Tensor = None) -> torch.Tensor:
    """Continuous Haar wavelet transform of the rows (last dimension) of a
    complex tensor, on its device.  The wavelet spectrum is computed in
    float64 NumPy and cast to x's complex type; ``fwd`` lets a caller that
    already has ``torch.fft.fft(x, dim=-1)`` share it."""
    psi = _haar_spectrum_np(x.shape[-1], scale).astype(
        np.complex64 if x.dtype == torch.complex64 else np.complex128)
    if fwd is None:
        fwd = torch.fft.fft(x, dim=-1)
    w = torch.fft.ifft(fwd * torch.from_numpy(psi).to(x.device), dim=-1)
    return w[..., 2 * scale: -2 * scale]


# ---------------------------------------------------------------------------
# batched classification statistics
# ---------------------------------------------------------------------------


def _abs_of_complex_max(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """|max| of each row under NumPy's lexicographic complex order (the
    largest real part, ties broken by the imaginary part), as urh_tpu
    normalizes a row; torch.max takes no complex tensor."""
    max_re = re.max(dim=-1, keepdim=True).values
    max_im = torch.where(re == max_re, im, float("-inf")).max(dim=-1).values
    return torch.hypot(max_re[..., 0], max_im)


def _median_host(rows: torch.Tensor, k: int) -> torch.Tensor:
    """The median's host route under "auto", urh_tpu's host twin: from
    NATIVE_MEDIAN_MIN_CELLS cells the full windows by the native library
    (float64 in, float32 out), the shrunk tail windows and smaller rows by
    B7's plain version.  The native code orders values by ``<``: -0.0 and
    +0.0 tie, so a zero median may come out with either sign, and a window
    that holds a NaN has no defined order; every other window equals the
    plain version's to the bit."""
    w = rows.shape[-1]
    full = w - int(k) + 1
    lib = get_library() if full > 0 and rows.numel() >= NATIVE_MEDIAN_MIN_CELLS else None
    if lib is None:
        return median_filter(rows, k)
    flat = np.ascontiguousarray(rows.reshape(-1, w).numpy(), dtype=np.float64)
    body = np.empty((flat.shape[0], full), dtype=np.float32)
    fn = (lib.urh_median_sliding if k <= NATIVE_MEDIAN_SLIDING_MAX_K
          else lib.urh_median_full_windows)
    fn(flat.ctypes.data, flat.shape[0], w, int(k), body.ctypes.data)
    # window i of the tail is rows[i:], all of it inside the last k - 1 columns
    tail = median_filter(rows[..., full:].contiguous(), k)
    return torch.cat((torch.from_numpy(body).reshape(*rows.shape[:-1], full), tail), dim=-1)


def median_filter_rows(rows: torch.Tensor, k: int, device=None) -> torch.Tensor:
    """Forward-window median of each row of a float32 tensor (B7 on the
    card, its plain version on the CPU), on the rows' device, or on
    ``device`` when given.  Under ``"auto"`` rows on the card stay there
    (B7); rows on the CPU are placed by urh_tpu's rule: the card from
    DEVICE_MIN_CELLS cells while the I/O cost (8 B a cell up, 4 back) stays
    below 5 ns a cell, else :func:`_median_host`."""
    if device is None or (placement.is_auto(device) and rows.device.type != "cpu"):
        return median_filter(rows, k)
    n = rows.numel()
    dev, side = placement.choose(
        "ai.median_filter_rows", device,
        lambda: use_device(n) and placement.device_io_cost_s(8 * n, 4 * n) < n * 5e-9)
    if side == "host":
        return _median_host(rows, k)
    return median_filter(rows.to(dev).contiguous(), k)


def _stats(re: torch.Tensor, im: torch.Tensor, scale: int, median_k: int,
           median_device=None) -> dict:
    """Classification statistics of (B, W) float32 I and Q planes on their
    device; only the (B,) results come back, in one copy.  The median runs
    on ``median_device`` when given (see median_filter_rows)."""
    norm_scale = _abs_of_complex_max(re, im)[:, None]
    data = torch.complex(re / norm_scale, im / norm_scale)
    mag = torch.hypot(re, im)
    unit = torch.complex(re / mag, im / mag)

    # one forward FFT of `data` feeds both the Haar CWT and the FSK test
    fwd = torch.fft.fft(data, dim=-1)
    mags = torch.cat((cwt_haar(data, scale, fwd=fwd).abs(), cwt_haar(unit, scale).abs()))
    # torch.var is unbiased by default; NumPy's and JAX's var are not
    var = torch.var(mags, dim=-1, correction=0)
    var_filtered = torch.var(median_filter_rows(mags, median_k, median_device), dim=-1,
                             correction=0)

    spectrum = torch.fft.fftshift(fwd, dim=-1).abs()
    values, order = torch.topk(spectrum, min(FFT_PEAK_COUNT, spectrum.shape[-1]), dim=-1)
    is_fsk = ((order - order[..., :1]).abs() >= FFT_PEAK_MIN_DISTANCE) & (
        values >= FFT_PEAK_MIN_POWER)

    b = len(re)
    host = torch.cat((var, var_filtered, is_fsk.any(dim=-1).float())).cpu().numpy()
    return {
        "var_mag": host[:b],
        "var_norm_mag": host[b:2 * b],
        "var_filtered_mag": host[2 * b:3 * b],
        "var_filtered_norm_mag": host[3 * b:4 * b],
        "is_fsk": host[4 * b:] != 0,
    }


def classification_stats(batch: np.ndarray, scale: int = 4, median_k: int = 11,
                         device=None) -> dict:
    """Per-row classification statistics of a (B, N) complex bucket.

    Returns var_mag / var_norm_mag / var_filtered_mag /
    var_filtered_norm_mag (float32 arrays, shape (B,)) and is_fsk (bool
    (B,)).  The median-filtered variances include the reference's shrunk
    end windows.  The bucket is uploaded to ``device`` (default: the CUDA
    card) as float32 planes; only per-message scalars come back.  Under
    ``"auto"`` urh_tpu's rule places it: the card from DEVICE_MIN_CELLS
    cells while the upload (8 B a cell) costs less than 15 ns a cell, else
    the CPU, whose median is placed again as urh_tpu's host twin places
    it."""
    batch = np.ascontiguousarray(batch, dtype=np.complex64)
    planes = torch.from_numpy(batch.view(np.float32).reshape(*batch.shape, 2))
    n = batch.size
    dev, side = placement.choose(
        "ai.classification_stats", device,
        lambda: use_device(n) and placement.device_io_cost_s(8 * n) < n * 15e-9)
    planes = planes.to(dev)
    return _stats(planes[..., 0], planes[..., 1], scale, median_k,
                  median_device=device if side == "host" else None)


def classification_stats_staged(planes: torch.Tensor, starts, width: int, scale: int = 4,
                                median_k: int = 11) -> dict:
    """classification_stats for contiguous same-width windows of a
    device-resident (N, 2) capture (IQData.staged_planes, raw units in the
    capture's dtype): the rows are gathered on its device by their start
    offsets, so only the offsets cross PCIe."""
    starts = torch.as_tensor(np.asarray(starts, dtype=np.int64)).to(planes.device)
    rows = planes[starts[:, None] + torch.arange(int(width), device=planes.device)]
    rows = rows.to(torch.float32)  # (B, width, 2)
    return _stats(rows[..., 0], rows[..., 1], scale, median_k)


# ---------------------------------------------------------------------------
# histogram (center detection)
# ---------------------------------------------------------------------------


def histogram(values: np.ndarray, bin_edges: np.ndarray, device=None) -> np.ndarray:
    """Counts of float32 ``values`` in uniform (np.arange-style) ``bin_edges``,
    on ``device`` (default: the CUDA card; ``"auto"`` places it), by
    urh_tpu's rule:

    * below HISTOGRAM_MIN_VALUES values, np.histogram's counts: float64
      comparisons with the edges, each bin half-open but the last, which is
      closed; this is not torch.histc, whose bins are computed in float32;
    * from HISTOGRAM_MIN_VALUES on, urh_tpu's device binning: the values in
      [edges[0], edges[-1]] (compared in float32) go to bin
      int((v - lo) / step) in float32 arithmetic, clipped to the last bin.
    """
    n_bins = len(bin_edges) - 1
    if n_bins <= 0:
        return np.zeros(0, dtype=np.int64)
    # under "auto" the card from HISTOGRAM_MIN_VALUES values, urh_tpu's rule
    device, _ = placement.choose(
        "ai.histogram", device,
        lambda: len(values) >= placement.scaled_threshold(HISTOGRAM_MIN_VALUES) and n_bins >= 2)
    v = torch.from_numpy(np.ascontiguousarray(values, dtype=np.float32)).to(device)
    if len(v) >= HISTOGRAM_MIN_VALUES and n_bins >= 2:
        lo = scalar_f32(bin_edges[0], device)
        step = scalar_f32(bin_edges[1] - bin_edges[0], device)
        inside = v[(v >= lo) & (v <= scalar_f32(bin_edges[-1], device))]
        # a 0-dim tensor divisor keeps the IEEE division on the card
        idx = ((inside - lo) / step).to(torch.int32).clamp(0, n_bins - 1)
    else:
        edges = torch.from_numpy(np.asarray(bin_edges, dtype=np.float64)).to(device)
        v = v.double()
        idx = torch.searchsorted(edges, v, right=True) - 1
        idx = torch.where(v == edges[-1], n_bins - 1, idx)  # the last bin is closed
        idx = idx[(idx >= 0) & (idx < n_bins)]
    return torch.bincount(idx, minlength=n_bins).cpu().numpy().astype(np.int64)
