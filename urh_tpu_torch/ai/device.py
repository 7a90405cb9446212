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

    One histogram of :func:`histograms`."""
    return histograms([values], [bin_edges], device=device)[0]


def _f32_keys(bits):
    """Order keys of float32 bit patterns (int32, a NumPy array or a torch
    tensor): the magnitude bits, negated for a negative float, so that the
    keys order as the floats do and -0.0 and +0.0 share the key 0."""
    lib = torch if isinstance(bits, torch.Tensor) else np
    return lib.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def _f32_toward(x: np.ndarray, inf: float) -> np.ndarray:
    """The float32 nearest float64 ``x`` on the side of ``inf`` (+inf: the
    least float32 >= x; -inf: the greatest <= x)."""
    with np.errstate(over="ignore"):
        f = x.astype(np.float32)
    off = f > x if inf < 0 else f < x
    return np.where(off, np.nextafter(f, np.float32(inf)), f)


def histograms(values: list, bin_edges: list, device=None, resident=None) -> list:
    """histogram() of each pair ``values[m]``, ``bin_edges[m]``, all counted in
    one pass on ``device`` (default: the CUDA card; ``"auto"`` places the
    batch once, by histogram()'s rule over the values of the messages with
    two bins or more).  Each message takes histogram()'s rule by its own
    size.  The values go up laid end to end with a small int64 table, in one
    copy; every count comes back in one copy, and in between the card waits
    for nothing.

    ``resident`` is (tensor, spans, above): the same values where they already
    lie on a device, span m = (start, stop, first, last) selecting, of
    tensor[start:stop], the values above ``above`` ranked first to last - 1.
    Where the histograms run on that device they read the values there, and
    only the table goes up.

    The count is over slots: message j owns ``n_j + 1`` keys from slot
    ``k_j`` on, and its bin i is slot ``k_j + 1 + i``; slot ``k_j`` takes
    what falls outside the bins of message j - 1 or j, or outside message
    j's span selection, and is dropped.  np.histogram's rule in float32
    keys: a float32 value v is >= a float64 edge e exactly when v is >= the
    least float32 >= e, and is <= the last edge exactly when it is below the
    least float32 past the greatest float32 <= it.  Those float32 bounds, and
    the values, become int64 keys, the message's index times 2^32 plus the
    float32's order key, so that one searchsorted over every message's keys
    gives each value its slot.  From HISTOGRAM_MIN_VALUES values on, a
    message's slot is urh_tpu's float32 bin instead."""
    n_bins = [len(e) - 1 for e in bin_edges]
    out = [np.zeros(0, dtype=np.int64) for _ in values]
    batch = [m for m, k in enumerate(n_bins) if k > 0]
    if not batch:
        return out
    sizes = np.array([len(values[m]) for m in batch], dtype=np.int64)
    bins = np.array([n_bins[m] for m in batch], dtype=np.int64)
    # under "auto" the card from HISTOGRAM_MIN_VALUES values, urh_tpu's rule
    device, _ = placement.choose(
        "ai.histogram", device,
        lambda: int(sizes[bins >= 2].sum()) >= placement.scaled_threshold(HISTOGRAM_MIN_VALUES))
    wide = (sizes >= HISTOGRAM_MIN_VALUES) & (bins >= 2)  # urh_tpu's float32 binning
    b = len(batch)
    in_place = resident is not None and resident[0].device == device
    if in_place:
        start, stop, first, last = np.array([resident[1][m] for m in batch], dtype=np.int64).T
        lengths = stop - start  # the pass runs over each message's span
        in_place = bool((lengths > 0).all())
    if not in_place:
        lengths = sizes
    at = np.zeros(b + 1, dtype=np.int64)  # where each message starts in the pass
    np.cumsum(lengths, out=at[1:])
    n = int(at[-1])
    slots = np.zeros(b + 1, dtype=np.int64)  # k_j
    np.cumsum(bins + 1, out=slots[1:])
    total = int(slots[-1])

    # one buffer: the int64 table (the keys, then rows of b: lengths, k_j, n_j
    # where urh_tpu's float32 binning counts, and for a resident source each
    # span's start in the tensor less its start in the pass, first, last),
    # then float32: the values unless they are resident, and each message's
    # lower and upper edge and bin width
    rows = total + (6 if in_place else 3) * b
    sent = 0 if in_place else n
    host = np.empty(8 * rows + 4 * (sent + 3 * b), dtype=np.uint8)
    table, flat = host[:8 * rows].view(np.int64), host[8 * rows:].view(np.float32)
    if not in_place:
        for j, m in enumerate(batch):
            flat[at[j]:at[j + 1]] = values[m]
    edges = np.concatenate([np.asarray(bin_edges[m], dtype=np.float64) for m in batch])
    ends = slots[1:] - 1  # each message's last edge
    bounds = _f32_toward(edges, np.inf)
    bounds[ends] = np.nextafter(_f32_toward(edges[ends], -np.inf), np.float32(np.inf))
    table[:total] = (np.repeat(np.arange(b, dtype=np.int64), bins + 1) << 32) + _f32_keys(
        bounds.view(np.int32).astype(np.int64))
    flat[sent:sent + b], flat[sent + b:sent + 2 * b] = edges[slots[:-1]], edges[ends]
    flat[sent + 2 * b:] = edges[slots[:-1] + 1] - edges[slots[:-1]]
    table[total:total + 3 * b] = np.concatenate((lengths, slots[:-1], np.where(wide, bins, 0)))
    if in_place:
        table[total + 3 * b:] = np.concatenate((start - at[:-1], first, last))

    both = torch.from_numpy(host).to(device)
    t, up = both[:8 * rows].view(torch.int64), both[8 * rows:].view(torch.float32)
    keys = t[:total]
    lengths_d, k, wide_bins = t[total:total + 3 * b].view(3, b)
    j = torch.repeat_interleave(torch.arange(b, device=device), lengths_d, output_size=n)
    chosen = None
    if in_place:
        tensor, _, above = resident
        start_less_at, first_d, last_d = t[total + 3 * b:].view(3, b)
        v = tensor[torch.arange(n, device=device) + start_less_at[j]]
        # each value's rank among its span's values above `above`
        chosen = v > above
        before = torch.cumsum(chosen, 0) - chosen.to(torch.int64)
        rank = before - before[torch.cumsum(lengths_d, 0) - lengths_d][j]
        del before
        chosen &= (rank >= first_d[j]) & (rank < last_d[j])
        del rank
    else:
        v = up[:n]
    key = (j << 32) + _f32_keys(v.view(torch.int32))
    slot = torch.searchsorted(keys, key, right=True)
    del key
    dump = k[j]
    if wide.any():
        lower, upper, width = up[sent:].view(3, b)
        # IEEE division by a tensor; clipped to the message's last bin
        binned = ((v - lower[j]) / width[j]).to(torch.int32).to(torch.int64)
        binned = torch.minimum(binned.clamp_(min=0), wide_bins[j] - 1)
        inside = (v >= lower[j]) & (v <= upper[j])
        slot = torch.where(wide_bins[j] != 0, torch.where(inside, dump + 1 + binned, dump), slot)
    if chosen is not None:
        slot = torch.where(chosen, slot, dump)
    counts = torch.zeros(total + 1, dtype=torch.int64, device=device)
    counts.index_add_(0, slot, torch.ones(1, dtype=torch.int64, device=device).expand(n))
    counts = counts.cpu().numpy()
    for i, m in enumerate(batch):
        out[m] = counts[slots[i] + 1:slots[i + 1]].copy()
    return out
