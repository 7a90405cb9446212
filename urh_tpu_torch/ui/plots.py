"""Headless visualization (PyTorch port of urh_tpu.ui.plots).

Replaces the reference's Qt painting layer (urh/ui/painting, 82k LoC of
generated Qt code) with renderer-agnostic outputs: min/max-decimated
plot paths (urh_tpu_torch.dsp.decimation), BGRA spectrogram images
(urh_tpu_torch.dsp.spectrogram) and optional matplotlib PNG export for
signals, demodulated views and spectrograms.  The plot paths of a signal
and its demodulated view are reduced on the signal's device; a
spectrogram on ``device`` (default: the CUDA card).  matplotlib is
imported only by the functions that draw with it.
"""

from __future__ import annotations

import numpy as np

from urh_tpu_torch.dsp.decimation import create_path
from urh_tpu_torch.dsp.spectrogram import Spectrogram


def _get_pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_waveform_rgba(y: np.ndarray, width: int = 600, height: int = 120,
                         color=(122, 162, 255, 255),
                         background=(13, 14, 18, 255)) -> np.ndarray:
    """Rasterize a 1-D waveform into an (height, width, 4) RGBA bitmap,
    oscilloscope style: each pixel column is filled between the min and
    max of the samples mapped into it (the reference's ZoomableScene
    min/max path painting, cythonext/path_creator.pyx:19-84, as a
    deterministic CPU rasterizer).  Pure NumPy; byte-stable for golden
    tests."""
    y = np.asarray(y, dtype=np.float64)
    image = np.empty((height, width, 4), dtype=np.uint8)
    image[:] = np.asarray(background, dtype=np.uint8)
    if len(y) == 0 or width <= 0 or height <= 0:
        return image
    lo, hi = float(y.min()), float(y.max())
    span = (hi - lo) or 1.0
    # sample -> column, value -> row (row 0 is the top = max value)
    cols = np.minimum((np.arange(len(y)) * width) // max(len(y), 1),
                      width - 1).astype(np.int64)
    rows = ((hi - y) / span * (height - 1)).round().astype(np.int64)
    col_min = np.full(width, height, dtype=np.int64)
    col_max = np.full(width, -1, dtype=np.int64)
    np.minimum.at(col_min, cols, rows)
    np.maximum.at(col_max, cols, rows)
    # connect adjacent columns so single-sample columns still join up
    prev_rows = np.concatenate([rows[:1], rows[:-1]])
    np.minimum.at(col_min, cols, prev_rows)
    np.maximum.at(col_max, cols, prev_rows)
    filled = col_max >= 0
    grid = np.arange(height)[:, None]
    mask = (grid >= col_min[None, :]) & (grid <= col_max[None, :]) & filled
    image[mask] = np.asarray(color, dtype=np.uint8)
    return image


def plot_signal(signal, filename: str, show_qad=False):
    """Render a signal's real part (and optionally the demodulated view)
    to an image file, min/max decimated like the GUI's signal frame."""
    plt = _get_pyplot()
    nrows = 2 if show_qad else 1
    fig, axes = plt.subplots(nrows, 1, figsize=(12, 3 * nrows), squeeze=False)

    (x, y), = create_path(signal.real_plot_data, 0, signal.num_samples,
                          device=signal.device)
    axes[0][0].plot(x, y, linewidth=0.5)
    axes[0][0].set_title(signal.name)
    axes[0][0].set_xlabel("sample")

    if show_qad:
        qad = signal.qad.cpu().numpy()
        (x, y), = create_path(qad, 0, len(qad), device=signal.device)
        axes[1][0].plot(x, y, linewidth=0.5, color="tab:orange")
        axes[1][0].set_title("demodulated")
        axes[1][0].set_xlabel("sample")

    fig.tight_layout()
    fig.savefig(filename, dpi=120)
    plt.close(fig)
    return filename


def plot_spectrogram(samples, filename: str, sample_rate=1e6,
                     window_size=Spectrogram.DEFAULT_FFT_WINDOW_SIZE,
                     colormap="magma", device=None):
    """Render an STFT spectrogram (computed on ``device``) to an image file."""
    plt = _get_pyplot()
    from urh_tpu_torch.util import colormaps

    colormaps.choose_colormap(colormap)
    spec = Spectrogram(samples, window_size=window_size, device=device)
    image = spec.create_spectrogram_image()

    # BGRA -> RGB for matplotlib
    rgb = image[:, :, [2, 1, 0]]
    fig, ax = plt.subplots(figsize=(12, 6))
    duration = len(spec.samples) / sample_rate
    ax.imshow(np.rot90(rgb, k=-1), aspect="auto",
              extent=[0, duration, -sample_rate / 2, sample_rate / 2])
    ax.set_xlabel("time [s]")
    ax.set_ylabel("frequency [Hz]")
    fig.tight_layout()
    fig.savefig(filename, dpi=120)
    plt.close(fig)
    return filename


def plot_messages(messages, filename: str, view=0):
    """Render a protocol table (bit/hex view with label coloring) to an
    image file — the headless analysis-tab equivalent."""
    plt = _get_pyplot()
    rows = []
    for msg in messages:
        rows.append(msg.view_to_string(view, decoded=True, show_pauses=False))

    fig, ax = plt.subplots(figsize=(12, 0.4 * max(1, len(rows)) + 1))
    ax.axis("off")
    for i, row in enumerate(rows):
        ax.text(0, 1 - (i + 1) / (len(rows) + 1), f"{i}: {row}",
                family="monospace", fontsize=8, transform=ax.transAxes)
    fig.tight_layout()
    fig.savefig(filename, dpi=120)
    plt.close(fig)
    return filename
