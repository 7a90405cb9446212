"""STFT spectrogram (PyTorch port of urh_tpu.dsp.spectrogram).

Counterpart of urh/signalprocessing/Spectrogram.py: short-time Fourier
transform with configurable window/overlap, dB conversion
(util.pyx:38-48), fftshift + flip for display, `.fta` export and BGRA
image rendering.  The STFT is a strided frame view (``unfold``) and one
batched ``torch.fft.fft`` on the Spectrogram's device; only the float32
dB image comes back to the host.  A Spectrogram made with
``device="auto"`` places each dB image as urh_tpu does: on the card while
the upload (8 B a sample) and the image (4 B a cell) cost at most 10 ns a
cell, else on the CPU; its ``stft`` runs on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.util import placement

# symmetric windows, as jnp.hanning and its siblings give them (torch's
# hann_window is periodic by default)
_WINDOWS = {"hanning": np.hanning, "hamming": np.hamming, "blackman": np.blackman}


def _window(window_kind: str, window_size: int, device) -> torch.Tensor:
    values = _WINDOWS.get(window_kind, np.ones)(window_size)
    return torch.from_numpy(np.asarray(values, dtype=np.float32)).to(device)


def _stft_device(samples: torch.Tensor, window_size: int, hop_size: int,
                 num_frames: int, window_kind: str) -> torch.Tensor:
    """(num_frames, window_size) complex64 STFT of a complex64 tensor."""
    window = _window(window_kind, window_size, samples.device)
    frames = samples.unfold(0, window_size, hop_size)[:num_frames]
    return torch.fft.fft(frames * window, window_size, dim=1) / window_size


def _stft_db_device(samples: torch.Tensor, window_size: int, hop_size: int,
                    num_frames: int, window_kind: str) -> torch.Tensor:
    """Fused STFT -> dB -> fftshift on the samples' device: the complex
    frames never leave it, only the float32 dB image does."""
    db = arr2decibel(_stft_device(samples, window_size, hop_size, num_frames, window_kind))
    return torch.fft.fftshift(db, dim=1)


def arr2decibel(arr: torch.Tensor) -> torch.Tensor:
    """10*log10 power (util.pyx:38-48); a zero power gives -inf."""
    power = arr.real * arr.real + arr.imag * arr.imag
    return (10.0 * torch.log10(power)).to(torch.float32)


class Spectrogram:
    MAX_LINES_PER_VIEW = 1000
    DEFAULT_FFT_WINDOW_SIZE = 1024

    def __init__(self, samples, window_size=DEFAULT_FFT_WINDOW_SIZE,
                 overlap_factor=0.5, window_function="hanning", device=None):
        self.device = placement.requested(device)
        self._samples = np.zeros(1, dtype=np.complex64)
        self.samples = samples
        self.window_size = window_size
        self.overlap_factor = overlap_factor
        self.window_function = window_function
        self.data_min, self.data_max = -140, 10

    @property
    def samples(self):
        return self._samples

    @samples.setter
    def samples(self, value):
        if isinstance(value, IQData):
            value = value.as_complex64()
        elif isinstance(value, np.ndarray) and value.dtype != np.complex64:
            value = IQData(value).as_complex64()
        elif value is None:
            value = np.zeros(1, dtype=np.complex64)
        self._samples = value

    @property
    def time_bins(self):
        return int(math.ceil(len(self.samples) / self.hop_size))

    @property
    def freq_bins(self):
        return self.window_size

    @property
    def hop_size(self):
        return self.window_size - int(self.overlap_factor * self.window_size)

    def _frame_params(self, samples: np.ndarray):
        hop_size = self.hop_size
        if len(samples) < self.window_size:
            samples = np.append(
                samples, np.zeros(self.window_size - len(samples), dtype=samples.dtype)
            )
        num_frames = max(1, (len(samples) - self.window_size) // hop_size + 1)
        wf = self.window_function if isinstance(self.window_function, str) else "hanning"
        return samples, hop_size, num_frames, wf

    @staticmethod
    def _upload(samples: np.ndarray, device) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(samples, dtype=np.complex64)).to(device)

    def stft(self, samples: np.ndarray) -> np.ndarray:
        samples, hop_size, num_frames, wf = self._frame_params(samples)
        out = _stft_device(self._upload(samples, placement.place(self.device)[0]), self.window_size,
                           hop_size, num_frames, wf)
        return out.cpu().numpy()

    def _calculate_spectrogram(self, samples: np.ndarray) -> np.ndarray:
        samples, hop_size, num_frames, wf = self._frame_params(samples)
        cells = num_frames * self.window_size
        device, _ = placement.choose(
            "dsp.spectrogram", self.device,
            lambda: placement.device_io_cost_s(8 * len(samples), 4 * cells) <= cells * 10e-9)
        spectrogram = _stft_db_device(self._upload(samples, device), self.window_size, hop_size,
                                      num_frames, wf).cpu().numpy()
        return np.fliplr(spectrogram)  # Y axis from negative to positive freq

    def export_to_fta(self, sample_rate, filename: str, include_amplitude=False):
        """Frequency (f64), Time in ns (u32)[, Amplitude (f32)] export."""
        spectrogram = self._calculate_spectrogram(self.samples)
        spectrogram = np.flipud(spectrogram.T)
        if include_amplitude:
            result = np.empty((spectrogram.shape[0], spectrogram.shape[1], 3),
                              dtype=[("f", np.float64), ("t", np.uint32), ("a", np.float32)])
        else:
            result = np.empty((spectrogram.shape[0], spectrogram.shape[1], 2),
                              dtype=[("f", np.float64), ("t", np.uint32)])

        fft_freqs = np.fft.fftshift(np.fft.fftfreq(spectrogram.shape[0], 1 / sample_rate))
        time_width = 1e9 * ((len(self.samples) / sample_rate) / spectrogram.shape[1])

        for i in range(spectrogram.shape[0]):
            for j in range(spectrogram.shape[1]):
                if include_amplitude:
                    result[i, j] = (fft_freqs[i], int(j * time_width), spectrogram[i, j])
                else:
                    result[i, j] = (fft_freqs[i], int(j * time_width))
        result.tofile(filename)

    def create_spectrogram_image(self, sample_start=None, sample_end=None, step=None,
                                 transpose=False) -> np.ndarray:
        from urh_tpu_torch.util import colormaps

        spectrogram = self._calculate_spectrogram(self.samples[sample_start:sample_end:step])
        if transpose:
            spectrogram = np.flipud(spectrogram.T)
        return self.create_image(spectrogram, colormaps.chosen_colormap_numpy_bgra,
                                 self.data_min, self.data_max)

    def create_image_segments(self):
        n_segments = max(1, self.time_bins // self.MAX_LINES_PER_VIEW)
        step = self.time_bins / n_segments
        step = max(1, int((step / self.hop_size) * self.hop_size ** 2))
        for i in range(0, len(self.samples), step):
            yield self.create_spectrogram_image(sample_start=i, sample_end=i + step)

    @staticmethod
    def color_indices(data: np.ndarray, n_colors: int, data_min=None, data_max=None,
                      normalize=True) -> np.ndarray:
        """The colormap row of every cell of data.T: the dB range spread
        over the map, -inf (silent bins) to the lowest color."""
        if normalize and (data_min is None or data_max is None):
            raise ValueError("can't normalize without data min and data max")
        if normalize:
            normalized = (n_colors - 1) * ((data.T - data_min) / (data_max - data_min))
        else:
            normalized = data.T
        normalized = np.nan_to_num(normalized, nan=0.0, posinf=n_colors - 1, neginf=0.0)
        return np.clip(normalized.astype(int), 0, n_colors - 1)

    @staticmethod
    def apply_bgra_lookup(data: np.ndarray, colormap, data_min=None, data_max=None,
                          normalize=True) -> np.ndarray:
        indices = Spectrogram.color_indices(data, len(colormap), data_min, data_max, normalize)
        return np.take(colormap, indices, axis=0)

    @staticmethod
    def create_image(data: np.ndarray, colormap, data_min=None, data_max=None,
                     normalize=True) -> np.ndarray:
        """BGRA image array (H, W, 4) uint8 (no GUI toolkit dependency)."""
        image_data = Spectrogram.apply_bgra_lookup(data, colormap, data_min, data_max, normalize)
        return np.ascontiguousarray(image_data)
