"""Signal: a loaded capture plus its demodulation parameter state.

PyTorch port of urh_tpu.core.signal (behavioral counterpart of
urh/signalprocessing/Signal.py, without Qt).  Holds an :class:`IQData`
plus the demodulation parameters and the device the signal is
demodulated on; caches the quadrature-demodulated ("rectangular") signal
as a tensor on that device.  A signal made with ``device="auto"`` lives
on the card and hands ``"auto"`` to the calls urh_tpu places (estimation,
``afp_demod`` of the samples, awre), which may run them on the CPU.  File
loaders cover ``.complex*`` raw formats, ``.wav``, Flipper ``.sub`` and
``.coco`` (bz2 tar) archives (Signal.py:85-213).
"""

from __future__ import annotations

import math
import os
import re
import tarfile
import tempfile
import wave

import numpy as np
import torch

from urh_tpu_torch.core.iq import IQData, min_max_for_dtype
from urh_tpu_torch.dsp import demod as _demod
from urh_tpu_torch.dsp import fused_kernels as _fk
from urh_tpu_torch.dsp.demod import DemodParams
from urh_tpu_torch.util import placement
from urh_tpu_torch.util.metrics import metrics


class Signal:
    def __init__(self, filename: str = "", name: str = "Signal", modulation: str = "FSK",
                 sample_rate: float = 1e6, device=None):
        # the device as asked for, "auto" kept for the placed calls
        self.requested_device = placement.requested(device)
        self.device = placement.place(device)[0]
        self.name = name
        self.filename = filename
        self.timestamp = 0.0
        self.already_demodulated = False
        self.iq_array = IQData(None, np.int8, n=0)

        self.params = DemodParams(modulation=modulation, sample_rate=sample_rate)
        self.auto_detect_on_modulation_changed = False
        self._qad = None
        self._noise_from_auto_detect = False
        # per-modulation parameter cache (Signal.py:78-81)
        self.parameter_cache = {
            mod: {"center": None, "samples_per_symbol": None}
            for mod in ("ASK", "FSK", "PSK", "OQPSK")
        }

        if filename:
            if filename.endswith(".wav"):
                self._load_wav_file(filename)
            elif filename.endswith(".sub"):
                self._load_sub_file(filename)
            elif filename.endswith(".coco"):
                self._load_compressed_complex(filename)
            else:
                self.iq_array = IQData.from_file(filename)
            if not self.already_demodulated:
                self.noise_threshold = self.detect_noise_threshold()

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_file(cls, filename: str, **kwargs) -> "Signal":
        return cls(filename, name=os.path.splitext(os.path.basename(filename))[0], **kwargs)

    @classmethod
    def from_iq(cls, iq, sample_rate: float = 1e6, modulation: str = "FSK",
                device=None) -> "Signal":
        sig = cls("", modulation=modulation, sample_rate=sample_rate, device=device)
        sig.iq_array = iq if isinstance(iq, IQData) else IQData(np.asarray(iq))
        return sig

    # -- loaders ---------------------------------------------------------
    def _load_wav_file(self, filename: str):
        with wave.open(filename, "r") as w:
            num_channels, sample_width, sample_rate, num_frames, _, _ = w.getparams()
            widths = {1: (0, 255, np.uint8), 2: (-32768, 32767, np.int16),
                      3: (-8388608, 8388607, np.int32), 4: (-2147483648, 2147483647, np.int32)}
            if sample_width not in widths:
                raise ValueError(f"can't handle sample width {sample_width}")
            lo, hi, fmt = widths[sample_width]
            center = (lo + hi) / 2
            frames = w.readframes(num_frames * num_channels)
        if sample_width == 3:
            n = len(frames) // (3 * num_channels)
            arr = np.empty((n, num_channels, 4), dtype=np.uint8)
            raw = np.frombuffer(frames, dtype=np.uint8)
            arr[:, :, :3] = raw.reshape(-1, num_channels, 3)
            arr[:, :, 3:] = (arr[:, :, 2:3] >> 7) * 255
            data = arr.view(np.int32).flatten()
        else:
            data = np.frombuffer(frames, dtype=fmt)

        self.iq_array = IQData(None, np.float32, n=num_frames)
        if num_channels == 1:
            self.iq_array.real = np.multiply(1 / hi, np.subtract(data, center))
            self.already_demodulated = True
        elif num_channels == 2:
            self.iq_array.real = np.multiply(1 / hi, np.subtract(data[0::2], center))
            self.iq_array.imag = np.multiply(1 / hi, np.subtract(data[1::2], center))
        else:
            raise ValueError(f"can't handle {num_channels} channels")
        self.params.sample_rate = sample_rate

    def _load_sub_file(self, filename: str):
        # Flipper RAW OOK: positive run -> above center, negative -> below.
        chunks = []
        with open(filename, "r") as f:
            for line in f:
                m = re.match(r"RAW_Data:\s*([-0-9 ]+)\s*$", line)
                if not m:
                    continue
                for value in m[1].strip().split(" "):
                    try:
                        v = int(value)
                    except ValueError:
                        continue
                    chunks.append(np.full(abs(v), 255 if v > 0 else 0, dtype=np.uint8))
        arr = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.uint8)
        self.iq_array = IQData(None, np.float32, n=len(arr))
        self.iq_array.real = np.multiply(1 / 255, np.subtract(arr, 127.5))
        self.already_demodulated = True

    def _load_compressed_complex(self, filename: str):
        with tarfile.open(filename, "r") as tar:
            member = tar.getmembers()[0]
            tmpdir = tempfile.mkdtemp()
            tar.extract(member, tmpdir, filter="data")
            extracted = os.path.join(tmpdir, tar.getnames()[0])
            self.iq_array = IQData.from_file(extracted)
            os.remove(extracted)

    # -- parameter properties (invalidate qad cache on change) -----------
    def _param(name):
        def get(self):
            return getattr(self.params, name)

        def set(self, value):
            if getattr(self.params, name) != value:
                setattr(self.params, name, value)
                self._qad = None

        return property(get, set)

    samples_per_symbol = _param("samples_per_symbol")
    tolerance = _param("tolerance")
    center_spacing = _param("center_spacing")
    pause_threshold = _param("pause_threshold")
    message_length_divisor = _param("message_length_divisor")
    costas_loop_bandwidth = _param("costas_loop_bandwidth")

    del _param

    @property
    def center(self):
        return self.params.center

    @center.setter
    def center(self, value):
        if self.params.center != value:
            self.params.center = value
            # qad itself does not depend on center, but fused-kernel symbol
            # states do
            self.__qad_states = None

    @property
    def bits_per_symbol(self):
        return self.params.bits_per_symbol

    @bits_per_symbol.setter
    def bits_per_symbol(self, value):
        if self.params.bits_per_symbol != int(value):
            self.params.bits_per_symbol = int(value)
            self._qad = None

    @property
    def modulation_type(self):
        return self.params.modulation

    @modulation_type.setter
    def modulation_type(self, value):
        if self.params.modulation != value:
            self.params.modulation = value
            self._qad = None

    @property
    def modulation_order(self):
        return self.params.modulation_order

    @property
    def noise_threshold(self):
        return self.params.noise_threshold

    @noise_threshold.setter
    def noise_threshold(self, value):
        if self.params.noise_threshold != value:
            self.params.noise_threshold = value
            self._qad = None

    @property
    def sample_rate(self):
        return self.params.sample_rate

    @sample_rate.setter
    def sample_rate(self, value):
        self.params.sample_rate = value

    # compat aliases with reference naming
    @property
    def qad_center(self):
        return self.params.center

    @qad_center.setter
    def qad_center(self, value):
        self.center = value

    # -- data properties -------------------------------------------------
    @property
    def num_samples(self) -> int:
        return self.iq_array.num_samples

    @property
    def max_magnitude(self) -> float:
        """Full-scale magnitude for the RELATIVE noise threshold scale
        (Signal.py:404-406).  NOTE: this deliberately differs from the
        demod kernel's per-dtype normalization constant
        (signal_functions.pyx:343-354): e.g. int8 gives sqrt(2*128**2)
        = 181.02 here but sqrt(127**2+128**2) = 180.31 in the kernel."""
        mi, ma = min_max_for_dtype(self.iq_array.dtype)
        return (2 * max(mi ** 2, ma ** 2)) ** 0.5

    @property
    def max_amplitude(self) -> float:
        mi, ma = min_max_for_dtype(self.iq_array.dtype)
        return 0.5 * (ma - mi)

    @property
    def noise_threshold_relative(self):
        return self.params.noise_threshold / self.max_magnitude

    @noise_threshold_relative.setter
    def noise_threshold_relative(self, value):
        self.noise_threshold = value * self.max_magnitude

    @property
    def magnitudes(self) -> np.ndarray:
        return self.iq_array.magnitudes

    @property
    def real_plot_data(self) -> np.ndarray:
        return self.iq_array.real

    # _qad is a property so that every cache invalidation (internal or from
    # the analyzer, which assigns signal._qad = None directly) also drops
    # the fused-kernel symbol-state cache.
    @property
    def _qad(self):
        return self.__qad_cache

    @_qad.setter
    def _qad(self, value):
        self.__qad_cache = value
        self.__qad_states = None

    @property
    def qad_states(self):
        """Symbol states (tensor) matching ``qad`` when a fused demod kernel
        produced them alongside (None otherwise; depends on center)."""
        return self.__qad_states

    @property
    def qad(self) -> torch.Tensor:
        """Cached quadrature-demodulated (rectangular) signal, a float32
        tensor on the signal's device (Signal.py:421-431)."""
        if self._qad is None:
            if self.already_demodulated:
                self._qad = torch.from_numpy(np.ascontiguousarray(
                    self.real_plot_data, dtype=np.float32)).to(self.device)
            else:
                self.__pending_states = None
                self._qad = self.quad_demod()
                self.__qad_states = self.__pending_states
                self.__pending_states = None
        return self._qad

    def _fused_demod_eligible(self) -> bool:
        # the same routing on every device: the kernels run on the card and
        # their plain versions on the CPU
        return (self.params.modulation in ("ASK", "FSK")
                and self.params.bits_per_symbol == 1
                and self.iq_array.num_samples >= 2)

    def fast_symbol_states(self):
        """Symbol states via the cheapest available route, or None.

        For int8 captures this uses the int8-ingest fused kernels (3 bytes
        of device-memory traffic per sample, no float32 qad materialized);
        otherwise the float32 fused path (which caches qad too), or None
        for the qad-driven path."""
        if self._qad is not None or self.already_demodulated:
            return self.qad_states
        if (not self._fused_demod_eligible()
                or self.params.noise_threshold >= self.max_magnitude):
            return None
        if self.iq_array.dtype == np.int8:
            x = self.iq_array.staged_planes(self.device)
            states = None
            if self.params.modulation == "ASK":
                states = _fk.ask_symbolize_i8(x, self.params.noise_threshold,
                                              self.params.center,
                                              self.iq_array.max_magnitude)
            elif _fk.fsk_i8_supports(self.params.center):
                states = _fk.fsk_symbolize_i8(x, self.params.noise_threshold,
                                              self.params.center)
            # else |center| >= pi/2: the comparison kernel does not apply
            if states is not None:
                self.__qad_states = states  # qad itself stays lazy
                return states
        self.qad  # float32 fused path fills the state cache
        return self.qad_states

    def quad_demod(self) -> torch.Tensor:
        if self.params.noise_threshold < self.max_magnitude:
            if self._fused_demod_eligible():
                # raw units, converted on the device
                x = self.iq_array.staged_planes(self.device).to(torch.float32)
                if self.params.modulation == "ASK":
                    qad, states = _fk.ask_demod_symbolize(
                        x,
                        self.params.noise_threshold,
                        self.params.center,
                        self.iq_array.max_magnitude,
                    )
                else:
                    qad, states = _fk.fsk_demod_symbolize(
                        x,
                        self.params.noise_threshold,
                        self.params.center,
                    )
                self.__pending_states = states
                return qad
            return _demod.afp_demod(
                # a placed call gets the host samples, as urh_tpu's does
                self.iq_array.data if placement.is_auto(self.requested_device)
                else self.iq_array.staged_planes(self.device),
                self.params.noise_threshold,
                self.params.modulation,
                self.params.modulation_order,
                self.params.costas_loop_bandwidth,
                dtype=self.iq_array.dtype,
                device=self.requested_device,
            )
        return torch.zeros(2, dtype=torch.float32, device=self.device)

    def detect_noise_threshold(self) -> float:
        """URH's noise floor of the capture: by the power gate where
        estimate()'s staging rule puts the capture on the card (on the
        signal's device, or placed under "auto"), else on the host (the
        same level to the bit)."""
        from urh_tpu_torch.ai import estimate as est
        from urh_tpu_torch.ai import power_gate
        from urh_tpu_torch.ai.segmentation import detect_noise_level

        staged = est.stage(self.iq_array, self.requested_device)
        if est.gates(staged):
            return power_gate.noise_level(staged, self.iq_array)
        return detect_noise_level(self.iq_array.magnitudes)

    def auto_detect(self, detect_modulation: bool = True, detect_noise: bool = False) -> bool:
        """Estimate the parameters (urh_tpu_torch.ai.estimate) on the
        signal's device and set them; False when undecidable.  The capture
        stays staged on the device for the demodulation that follows."""
        from urh_tpu_torch.ai.estimate import estimate

        kwargs = {}
        if not detect_noise:
            kwargs["noise"] = self.params.noise_threshold
        if not detect_modulation:
            kwargs["modulation"] = self.params.modulation

        result = estimate(self.iq_array, device=self.requested_device, **kwargs)
        if result is None:
            return False
        self.noise_threshold = result["noise"]
        self.center = result["center"]
        self.samples_per_symbol = result["bit_length"]
        self.tolerance = result["tolerance"]
        self.modulation_type = result["modulation_type"]
        return True

    # -- editing ops (Signal.py:611-651) ---------------------------------
    def create_new(self, start=0, end=0, new_data=None) -> "Signal":
        sig = Signal("", device=self.requested_device)
        if new_data is None:
            sig.iq_array = IQData(self.iq_array[start:end], skip_conversion=True)
        else:
            sig.iq_array = IQData(new_data)
        sig.params = DemodParams(**vars(self.params))
        sig._noise_from_auto_detect = self._noise_from_auto_detect
        return sig

    def bandpass(self, f_low: float, f_high: float, filter_bw: float = None) -> "Signal":
        """A new signal of the samples band-pass filtered between the
        normalized frequencies ``f_low`` and ``f_high`` (in [-0.5, 0.5]):
        URH's "apply bandpass filter" on a band selected in the spectrogram
        (SignalFrame).  The filter is
        :meth:`Filter.apply_bandpass_filter`'s on the signal's device, of
        width ``filter_bw`` (default: the configured one); the new signal,
        named "<name> filtered", keeps the demodulation parameters."""
        from urh_tpu_torch.dsp.filters import Filter

        if filter_bw is None:
            filter_bw = Filter.read_configured_filter_bw()
        taps = Filter.get_filter_length_from_bandwidth(filter_bw)
        route = Filter.convolution_route(self.num_samples, taps)
        with metrics.span("filter.bandpass", samples=self.num_samples, taps=taps, route=route):
            # the FFT route converts the capture on the device, as it is staged there
            data = (self.iq_array.staged_complex64(self.device) if route == "card"
                    else self.iq_array.as_complex64())
            filtered = Filter.apply_bandpass_filter(data, f_low, f_high, filter_bw=filter_bw,
                                                    device=self.device)
            # create_new keeps the demodulation parameters (SignalFrame.py:1579)
            signal = self.create_new(new_data=filtered.astype(np.complex64, copy=False))
            signal.name = f"{self.name} filtered"
        return signal

    def crop_to_range(self, start: int, end: int):
        self.iq_array = IQData(self.iq_array[start:end], skip_conversion=True)
        self._qad = None

    def delete_range(self, start: int, end: int):
        mask = np.ones(self.num_samples, dtype=bool)
        mask[start:end] = False
        self.iq_array.apply_mask(mask)
        self._qad = None

    def mute_range(self, start: int, end: int):
        """Zero a sample range.  A cached qad gets the range zeroed; the
        fused kernels' states, which no longer match the samples, are
        dropped, so the next demodulation derives them from qad (urh_tpu's
        CPU route; its TPU route keeps them: ROADMAP C11)."""
        self.iq_array[start:end] = 0.0
        if self._qad is not None:
            self._qad[start:end] = 0.0
            self.__qad_states = None

    def insert_data(self, position: int, data: np.ndarray):
        self.iq_array.insert_subarray(position, data)
        self._qad = None

    def filter_range(self, start: int, end: int, fir_filter):
        """Apply an FIR filter to a sample range on the signal's device and
        re-demodulate it (Signal.py:642-651).  The filtered samples are
        written back cast to the capture's dtype (NumPy's cast: a float to
        an integer truncates toward zero).  A cached qad gets the range
        re-demodulated; the fused kernels' states, which no longer match
        the samples, are dropped, so the next demodulation derives them from
        qad (as urh_tpu's CPU route always does)."""
        filtered = fir_filter.work(np.ascontiguousarray(self.iq_array[start:end]),
                                   device=self.device)
        self.iq_array[start:end] = np.column_stack((filtered.real, filtered.imag)).astype(
            self.iq_array.dtype) if np.iscomplexobj(filtered) else filtered
        if self._qad is not None:
            self._qad[start:end] = _demod.afp_demod(
                self.iq_array[start:end], self.params.noise_threshold,
                self.params.modulation, self.params.modulation_order,
                self.params.costas_loop_bandwidth, device=self.requested_device)
            self.__qad_states = None

    @staticmethod
    def from_samples(samples: np.ndarray, name: str, sample_rate: float,
                     device=None) -> "Signal":
        signal = Signal("", name, sample_rate=sample_rate, device=device)
        signal.iq_array = IQData(samples)
        return signal

    def silent_set_modulation_type(self, mod: str):
        self.params.modulation = mod

    def estimate_frequency(self, start: int, end: int, sample_rate: float) -> float:
        """Dominant baseband frequency (absolute value) via FFT argmax
        (Signal.py:577-600)."""
        length = 2 ** int(math.log2(max(end - start, 1))) if end > start else 0
        data = self.iq_array.as_complex64()[start : start + length]
        try:
            w = np.fft.fft(data)
            frequencies = np.fft.fftfreq(len(w))
            idx = int(np.argmax(np.abs(w)))
            return abs(float(frequencies[idx]) * sample_rate)
        except ValueError:
            return 100e3  # empty window fallback

    def save_as(self, filename: str):
        self.filename = filename
        if filename.endswith(".coco"):
            self.iq_array.save_compressed(filename)
        elif filename.endswith(".wav"):
            self.iq_array.export_to_wav(filename, 2, self.sample_rate)
        elif filename.endswith(".sub"):
            self.iq_array.export_to_sub(filename)
        else:
            self.iq_array.tofile(filename)


def signal_from_reference(iq: np.ndarray, params: dict, device) -> Signal:
    """The port's Signal for numpy IQ and a plain dict of DemodParams
    fields, e.g. ``vars(other_signal.params)`` of a urh_tpu Signal."""
    sig = Signal.from_iq(iq, device=device)
    sig.params = DemodParams(**params)
    return sig
