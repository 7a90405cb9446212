"""Canonical IQ sample container.

The on-host container for complex baseband samples.  Samples are stored
as an ``(N, 2)`` interleaved real/imaginary array in one of five ingest
dtypes (int8, uint8, int16, uint16, float32) — never as numpy complex —
mirroring the reference semantics (urh/signalprocessing/IQArray.py:12-21).
The dtype conversion matrix preserves the reference's exact scale/shift
constants (IQArray.py:127-204) so downstream bit decisions match.

The samples live on the host; :meth:`IQData.staged_planes` hands one
cached copy in the capture's own dtype (raw units) to the device, where
all sample-rate compute in :mod:`urh_tpu_torch.dsp` runs.
"""

from __future__ import annotations

import math
import os
import tarfile
import tempfile
import wave

import numpy as np
import torch


# convert_to(np.float32)'s scale and shift of each ingest dtype
_FLOAT32_SCALE = {np.int8: (1 / 128, 0.0), np.uint8: (1 / 128, -1.0),
                  np.int16: (1 / 32768, 0.0), np.uint16: (1 / 32768, -1.0),
                  np.float32: (1.0, 0.0)}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    CUDA card.  Without a card the default raises instead of moving to the
    CPU; pass ``device="cpu"`` for the plain PyTorch versions.  ``"auto"``
    resolves to the card as the default does: the routes that place work
    between the card and the CPU (:mod:`urh_tpu_torch.util.placement`)
    read it before it gets here."""
    if device is None or (isinstance(device, str) and device == "auto"):
        if not torch.cuda.is_available():
            raise RuntimeError("urh_tpu_torch runs on a CUDA device by default "
                               "and none is available; pass device='cpu'")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


IQ_DTYPES = (np.int8, np.uint8, np.int16, np.uint16, np.float32)

# File extension -> raw storage dtype (IQArray.py:206-227)
_EXT_DTYPES = {
    ".complex16u": np.uint8,
    ".cu8": np.uint8,
    ".complex16s": np.int8,
    ".cs8": np.int8,
    ".complex32u": np.uint16,
    ".cu16": np.uint16,
    ".complex32s": np.int16,
    ".cs16": np.int16,
}


def min_max_for_dtype(dtype) -> tuple:
    dtype = np.dtype(dtype)
    if dtype in (np.float32, np.float64, np.complex64, np.complex128):
        return -1, 1
    info = np.iinfo(dtype)
    return info.min, info.max


def max_magnitude_for_dtype(dtype) -> float:
    """Full-scale magnitude used to normalize ASK envelopes.

    Matches the per-dtype table in the reference demodulator
    (urh/cythonext/signal_functions.pyx:343-354).
    """
    dtype = np.dtype(dtype)
    if dtype == np.int8:
        return math.sqrt(127 * 127 + 128 * 128)
    if dtype == np.uint8:
        return 255.0
    if dtype == np.int16:
        return math.sqrt(32768.0 * 32768.0 + 32767.0 * 32767.0)
    if dtype == np.uint16:
        return 65535.0
    if dtype == np.float32:
        return math.sqrt(2.0)
    raise ValueError(f"unsupported IQ dtype {dtype}")


def normalize_scale_shift(dtype) -> tuple:
    """(scale, shift) so that ``(raw + shift) / scale`` is in [-1, 1].

    Matches the Costas-loop normalization table
    (urh/cythonext/signal_functions.pyx:267-283).
    """
    dtype = np.dtype(dtype)
    if dtype == np.int8:
        return 127.5, 0.5
    if dtype == np.uint8:
        return 127.5, -127.5
    if dtype == np.int16:
        return 32767.5, 0.5
    if dtype == np.uint16:
        return 65535.0, -32767.5
    if dtype == np.float32:
        return 1.0, 0.0
    raise ValueError(f"unsupported IQ dtype {dtype}")


class IQData:
    """(N, 2) interleaved I/Q samples in one of the five ingest dtypes."""

    def __init__(self, data: np.ndarray = None, dtype=None, n=None, skip_conversion=False):
        if data is None:
            self._data = np.zeros((n, 2), dtype or np.float32, order="C")
        elif skip_conversion:
            self._data = data
        else:
            self._data = self.convert_array_to_iq(data)
        if self._data.dtype in (np.complex64, np.complex128):
            raise TypeError("IQData stores interleaved real arrays, not complex")
        self._staged = None  # cached device copy, see staged_planes

    # -- basic accessors -------------------------------------------------
    def __len__(self):
        return len(self._data)

    def __getitem__(self, item):
        return self._data[item]

    def staged_planes(self, device) -> torch.Tensor:
        """The (N, 2) capture resident on ``device`` in its own dtype,
        uploaded once and reused by every device stage — an int8 capture
        crosses PCIe at 2 B/sample and is converted on the card where a
        stage needs float32.  Invalidated by writes."""
        device = resolve_device(device)
        if self._staged is None or self._staged.device != device:
            self._staged = torch.from_numpy(
                np.ascontiguousarray(self._data)).to(device)
        return self._staged

    def __setitem__(self, key, value):
        self._staged = None
        if isinstance(value, IQData):
            value = value.data
        if isinstance(value, (int, float)):
            self._data[key] = value
        elif isinstance(value, np.ndarray) and value.dtype in (np.complex64, np.complex128):
            self._data[key, 0] = value.real
            self._data[key, 1] = value.imag
        elif isinstance(value, np.ndarray) and value.ndim == 1:
            self._data[key] = value.reshape((-1, 2), order="C")
        else:
            self._data[key] = value

    def __eq__(self, other):
        return np.array_equal(self.data, other.data)

    @property
    def data(self) -> np.ndarray:
        """Raw (N, 2) buffer.  In-place writes through this view bypass
        the staged-device-copy invalidation — call ``invalidate_staged()``
        afterwards (or write via ``__setitem__``/``real``/``imag``)."""
        return self._data

    def invalidate_staged(self):
        """Drop the cached device copy after direct writes to ``.data``."""
        self._staged = None

    @property
    def num_samples(self) -> int:
        return self._data.shape[0]

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def minimum(self):
        return min_max_for_dtype(self._data.dtype)[0]

    @property
    def maximum(self):
        return min_max_for_dtype(self._data.dtype)[1]

    @property
    def real(self) -> np.ndarray:
        return self._data[:, 0]

    @real.setter
    def real(self, value):
        self._staged = None
        self._data[:, 0] = value

    @property
    def imag(self) -> np.ndarray:
        return self._data[:, 1]

    @imag.setter
    def imag(self, value):
        self._staged = None
        self._data[:, 1] = value

    @property
    def magnitudes(self) -> np.ndarray:
        """Per-sample magnitude in raw units, float64 (util.pyx:128-136).

        einsum accumulates re*re+im*im in float64 in one pass over the
        raw buffer — no 2x-width float64 copy of the whole capture."""
        d = self._data
        return np.sqrt(np.einsum("ij,ij->i", d, d, dtype=np.float64))

    @property
    def magnitudes_normalized(self) -> np.ndarray:
        return self.magnitudes / np.sqrt(self.maximum ** 2.0 + self.minimum ** 2.0)

    @property
    def max_magnitude(self) -> float:
        return max_magnitude_for_dtype(self._data.dtype)

    def as_complex64(self) -> np.ndarray:
        """The samples as a complex64 array of the caller's own: a float32
        capture is copied, any other is converted once, into the array
        returned (a second pass into fresh pages costs as much as the first)."""
        planes = self.convert_to(np.float32)
        if planes is self._data:
            return np.ascontiguousarray(planes).flatten(order="C").view(np.complex64)
        return np.ascontiguousarray(planes).reshape(-1).view(np.complex64)

    def staged_complex64(self, device) -> torch.Tensor:
        """:meth:`as_complex64`'s values as an (N,) complex64 tensor on
        ``device``, converted there from :meth:`staged_planes`: the capture
        crosses PCIe in its own dtype, and the host makes no pass over it.
        Each conversion scales integers by a power of two (and shifts the
        unsigned ones by 1), so every value is exact and equals the host's."""
        if self._data.dtype.type not in _FLOAT32_SCALE:
            return torch.from_numpy(self.as_complex64()).to(resolve_device(device))
        scale, shift = _FLOAT32_SCALE[self._data.dtype.type]
        planes = self.staged_planes(device).to(torch.float32)
        if scale != 1.0:  # an integer capture: ``planes`` is a new tensor
            planes.mul_(scale).add_(shift)
        return planes.view(torch.complex64).reshape(-1)

    def complex64_range(self, start: int, end: int) -> np.ndarray:
        """:meth:`as_complex64`'s values of samples ``[start, end)``,
        converted from those samples alone: the conversion is elementwise, so
        each equals the whole capture's bit for bit.  A C-contiguous float32
        capture gives a view of its own buffer (for read-only consumers)."""
        planes = self._convert_planes(self._data[start:end], np.float32)
        return np.ascontiguousarray(planes).reshape(-1).view(np.complex64)

    def as_complex64_view(self) -> np.ndarray:
        """Zero-copy complex64 view for READ-ONLY consumers (float32
        buffers alias self.data; other dtypes fall back to a converted
        copy)."""
        return self.complex64_range(0, len(self))

    def as_raw_f32(self) -> np.ndarray:
        """Raw-unit float32 view (no normalization) for device transfer."""
        if self._data.dtype == np.float32:
            return self._data
        return self._data.astype(np.float32)

    def to_bytes(self):
        return self._data.tobytes()

    def subarray(self, start=None, stop=None, step=None) -> "IQData":
        return IQData(np.ascontiguousarray(self._data[start:stop:step]), skip_conversion=True)

    def insert_subarray(self, pos, subarray: np.ndarray):
        if subarray.ndim == 1:
            if subarray.dtype == np.complex64:
                subarray = subarray.view(np.float32).reshape((-1, 2), order="C")
            elif subarray.dtype == np.complex128:
                subarray = subarray.view(np.float64).reshape((-1, 2), order="C")
            else:
                subarray = subarray.reshape((-1, 2), order="C")
        self._data = np.insert(self._data, pos, subarray, axis=0)
        self._staged = None

    def apply_mask(self, mask: np.ndarray):
        self._data = self._data[mask]
        self._staged = None

    # -- dtype conversion matrix (IQArray.py:127-204) --------------------
    def convert_to(self, target_dtype) -> np.ndarray:
        return self._convert_planes(self._data, target_dtype)

    @staticmethod
    def _convert_planes(src: np.ndarray, target_dtype) -> np.ndarray:
        """:meth:`convert_to` of any (n, 2) planes in an ingest dtype: the
        planes themselves where the dtype is the target's."""
        sdt, tdt = src.dtype, np.dtype(target_dtype)
        if tdt == sdt:
            return src

        if sdt == np.uint8:
            if tdt == np.int8:
                return np.add(src, -128, dtype=np.int8, casting="unsafe")
            if tdt == np.int16:
                return np.add(src, -128, dtype=np.int16, casting="unsafe") << 8
            if tdt == np.uint16:
                return src.astype(np.uint16) << 8
            if tdt == np.float32:
                return np.add(np.multiply(src, 1 / 128, dtype=np.float32), -1.0, dtype=np.float32)
        elif sdt == np.int8:
            if tdt == np.uint8:
                return np.add(src, 128, dtype=np.uint8, casting="unsafe")
            if tdt == np.int16:
                return src.astype(np.int16) << 8
            if tdt == np.uint16:
                return np.add(src, 128, dtype=np.uint16, casting="unsafe") << 8
            if tdt == np.float32:
                return np.multiply(src, 1 / 128, dtype=np.float32)
        elif sdt == np.uint16:
            if tdt == np.int8:
                return (np.add(src, -32768, dtype=np.int16, casting="unsafe") >> 8).astype(np.int8)
            if tdt == np.uint8:
                return (src >> 8).astype(np.uint8)
            if tdt == np.int16:
                return np.add(src, -32768, dtype=np.int16, casting="unsafe")
            if tdt == np.float32:
                return np.add(np.multiply(src, 1 / 32768, dtype=np.float32), -1.0, dtype=np.float32)
        elif sdt == np.int16:
            if tdt == np.int8:
                return (src >> 8).astype(np.int8)
            if tdt == np.uint8:
                return (np.add(src, 32768, dtype=np.uint16, casting="unsafe") >> 8).astype(np.uint8)
            if tdt == np.uint16:
                return np.add(src, 32768, dtype=np.uint16, casting="unsafe")
            if tdt == np.float32:
                return np.multiply(src, 1 / 32768, dtype=np.float32)
        elif sdt == np.float32:
            if tdt == np.int8:
                return np.multiply(src, 127, dtype=np.float32).astype(np.int8)
            if tdt == np.uint8:
                return np.multiply(np.add(src, 1.0, dtype=np.float32), 127, dtype=np.float32).astype(np.uint8)
            if tdt == np.int16:
                return np.multiply(src, 32767, dtype=np.float32).astype(np.int16)
            if tdt == np.uint16:
                return np.multiply(np.add(src, 1.0, dtype=np.float32), 32767, dtype=np.float32).astype(np.uint16)

        raise ValueError(f"conversion {sdt} -> {tdt} not supported")

    # -- file IO (IQArray.py:115-125, 206-227) ---------------------------
    @staticmethod
    def from_file(filename: str) -> "IQData":
        for ext, dtype in _EXT_DTYPES.items():
            if filename.endswith(ext):
                raw = IQData(np.fromfile(filename, dtype=dtype))
                if dtype == np.uint8:
                    return IQData(raw.convert_to(np.int8))
                if dtype == np.uint16:
                    return IQData(raw.convert_to(np.int16))
                return raw
        return IQData(np.fromfile(filename, dtype=np.float32))

    def tofile(self, filename: str):
        for ext, dtype in _EXT_DTYPES.items():
            if filename.endswith(ext):
                self.convert_to(dtype).tofile(filename)
                return
        self.convert_to(np.float32).tofile(filename)

    def save_compressed(self, filename):
        with tarfile.open(filename, "w:bz2") as tar_write:
            tmp_name = tempfile.mkstemp()[1]
            self.tofile(tmp_name)
            tar_write.add(tmp_name)
        os.remove(tmp_name)

    def export_to_wav(self, filename, num_channels, sample_rate):
        with wave.open(filename, "w") as f:
            f.setnchannels(num_channels)
            f.setsampwidth(2)
            f.setframerate(int(sample_rate))
            f.writeframes(self.convert_to(np.int16).tobytes())

    def export_to_sub(self, filename, frequency=433920000, preset="FuriHalSubGhzPresetOok650Async"):
        """Flipper Zero SubGhz RAW export (run-length of envelope polarity)."""
        vals = self.convert_to(np.uint8)
        if vals.ndim > 1:
            vals = vals[:, 0]
        runs = []
        if len(vals):
            change = np.flatnonzero(np.diff(vals.astype(np.int16)) != 0) + 1
            bounds = np.concatenate(([0], change, [len(vals)]))
            for s, e in zip(bounds[:-1], bounds[1:]):
                n = int(e - s)
                runs.append(n if vals[s] > 127 else -n)
        with open(filename, "w") as f:
            f.write("Filetype: Flipper SubGhz RAW File\n")
            f.write("Version: 1\n")
            f.write(f"Frequency: {frequency}\n")
            f.write(f"Preset: {preset}\n")
            f.write("Protocol: RAW")
            for idx, r in enumerate(runs):
                if idx % 512 == 0:
                    f.write(f"\nRAW_Data: {r}")
                else:
                    f.write(f" {r}")
            f.write("\n")

    # -- misc ------------------------------------------------------------
    @staticmethod
    def convert_array_to_iq(arr: np.ndarray) -> np.ndarray:
        if arr.ndim == 1:
            if arr.dtype == np.complex64:
                arr = arr.view(np.float32)
            elif arr.dtype == np.complex128:
                arr = arr.view(np.float64)
            if len(arr) % 2 != 0:
                arr = arr[:-1]  # drop trailing half sample
            return arr.reshape((-1, 2), order="C")
        if arr.ndim == 2:
            return arr
        raise ValueError("too many dimensions")

    @staticmethod
    def concatenate(arrays) -> "IQData":
        return IQData(
            data=np.concatenate([a.data if isinstance(a, IQData) else a for a in arrays])
        )
