"""Min/max plot decimation (PyTorch port of urh_tpu.dsp.decimation).

Counterpart of the reference's plot-path kernel
(urh/cythonext/path_creator.pyx:19-84): reduce millions of samples to
at most PIXELS_PER_PATH min/max pairs for display.  The per-chunk
min/max is one ``amin``/``amax`` over a reshaped view on the device
(exact: a reduction picks one of its inputs); host plotting is
frontend-agnostic (returns x, y arrays).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from urh_tpu_torch.core.iq import resolve_device
from urh_tpu_torch.util import settings


def _minmax_decimate(samples: torch.Tensor, samples_per_pixel: int):
    n_chunks = samples.shape[0] // samples_per_pixel
    chunks = samples[: n_chunks * samples_per_pixel].view(n_chunks, samples_per_pixel)
    return torch.amin(chunks, dim=1), torch.amax(chunks, dim=1)


def create_path(samples: np.ndarray, start: int, end: int, subpath_ranges=None, device=None):
    """-> list of (x, y) arrays, one per subpath range; the min/max
    reduction runs on ``device`` (default: the CUDA card).

    y interleaves per-chunk minima and maxima like the reference, so a
    connected line through the points visualizes the signal envelope.
    """
    samples = np.asarray(samples)
    num_samples = end - start
    subpath_ranges = [(start, end)] if subpath_ranges is None else subpath_ranges
    pixels_on_path = settings.PIXELS_PER_PATH

    samples_per_pixel = int(num_samples / pixels_on_path)

    if samples_per_pixel > 1:
        values_f32 = np.ascontiguousarray(samples[start:end], dtype=np.float32)
        mins, maxs = _minmax_decimate(
            torch.from_numpy(values_f32).to(resolve_device(device)), samples_per_pixel)
        mins = mins.cpu().numpy()
        maxs = maxs.cpu().numpy()
        sample_rng = np.arange(start, start + len(mins) * samples_per_pixel,
                               samples_per_pixel, dtype=np.int64)
        x = np.repeat(sample_rng, 2)
        values = np.empty(2 * len(mins), dtype=np.float32)
        values[0::2] = mins
        values[1::2] = maxs
        scale_factor = num_samples / (2.0 * len(sample_rng))
    else:
        x = np.arange(start, end, dtype=np.int64)
        values = samples[start:end]
        scale_factor = 1.0

    if scale_factor == 0:
        scale_factor = 1

    result = []
    for subpath_range in subpath_ranges:
        sub_start = ((((subpath_range[0] - start) / scale_factor) * scale_factor)
                     - 2 * scale_factor) / scale_factor
        sub_start = int(max(0, math.floor(sub_start)))
        sub_end = ((((subpath_range[1] - start) / scale_factor) * scale_factor)
                   + 2 * scale_factor) / scale_factor
        sub_end = int(max(0, math.ceil(sub_end)))
        result.append((x[sub_start:sub_end], values[sub_start:sub_end]))
    return result


def create_live_path(samples: np.ndarray, start: int, end: int):
    return np.arange(start, end, dtype=np.int64), np.asarray(samples[start:end])
