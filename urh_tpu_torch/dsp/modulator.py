"""Modulator: TX configuration producing IQ from bits.

PyTorch port of urh_tpu.dsp.modulator, the counterpart of
urh/signalprocessing/Modulator.py: carrier frequency/phase/amplitude,
samples-per-symbol, bits-per-symbol, and a per-symbol parameter table
(amplitudes in %, frequencies in Hz, or phases in degrees).
Configuration/persistence is table-driven — one field registry feeds
``__eq__`` and the XML round trip — and ``modulate`` converts parameters
and calls the synthesis in urh_tpu_torch.dsp.modulate on the given device
(default: the CUDA card).
"""

from __future__ import annotations

import array
import math
import xml.etree.ElementTree as ET

import numpy as np

from urh_tpu_torch.core.iq import IQData, min_max_for_dtype
from urh_tpu_torch.dsp.modulate import modulate as _modulate_kernel

# family -> (verbose name, parameter legend, function of the default parameters)
_FAMILIES = {
    "ASK": ("Amplitude Shift Keying (ASK)", "Amplitudes in %:",
            lambda mod: np.linspace(0, 100, mod.modulation_order,
                                    dtype=np.float32)),
    "FSK": ("Frequency Shift Keying (FSK)", "Frequencies in Hz:",
            lambda mod: [(i + 1) * mod.carrier_freq_hz / mod.modulation_order
                         for i in range(mod.modulation_order)]),
    "PSK": ("Phase Shift Keying (PSK)", "Phases in degree:",
            lambda mod: mod._default_phases()),
}


class Modulator:
    FORCE_DTYPE = None

    MODULATION_TYPES = ["ASK", "FSK", "PSK", "GFSK", "OQPSK"]
    MODULATION_TYPES_VERBOSE = {
        "ASK": _FAMILIES["ASK"][0],
        "FSK": _FAMILIES["FSK"][0],
        "PSK": _FAMILIES["PSK"][0],
        "OQPSK": "Offset Quadrature Phase Shift Keying (OQPSK)",
        "GFSK": "Gaussian Frequeny Shift Keying (GFSK)",
    }

    # declarative XML field registry: attribute -> parser for reading
    _XML_SCALARS = {
        "name": str,
        "carrier_freq_hz": float,
        "carrier_amplitude": float,
        "carrier_phase_deg": float,
        "gauss_bt": float,
        "gauss_filter_width": float,
    }
    _COMPARED = ("carrier_freq_hz", "carrier_amplitude", "carrier_phase_deg",
                 "name", "modulation_type", "samples_per_symbol",
                 "bits_per_symbol", "sample_rate", "parameters")

    def __init__(self, name: str = ""):
        self.carrier_freq_hz = 40 * 10 ** 3
        self.carrier_amplitude = 1
        self.carrier_phase_deg = 0
        self.data = [True, False, True, False]
        self.samples_per_symbol = 100
        self.default_sample_rate = 10 ** 6
        self._sample_rate = None
        self._modulation_type = "ASK"
        self._bits_per_symbol = 1
        self.name = name
        self.gauss_bt = 0.5
        self.gauss_filter_width = 1
        # Freq in Hz, Amplitude in 0..100 %, Phase in 0..360 deg
        self.parameters = array.array("f", [0, 100])

    def __eq__(self, other):
        return all(getattr(self, field) == getattr(other, field)
                   for field in self._COMPARED)

    @staticmethod
    def get_dtype():
        if Modulator.FORCE_DTYPE is not None:
            return Modulator.FORCE_DTYPE
        from urh_tpu_torch.util import settings

        named = {"int8": np.int8, "int16": np.int16}
        return named.get(settings.read("modulation_dtype", "float32", str),
                         np.float32)

    # -- properties ------------------------------------------------------
    @property
    def modulation_type(self) -> str:
        return self._modulation_type

    @modulation_type.setter
    def modulation_type(self, value):
        try:
            # legacy support: modulation type saved as int index
            self._modulation_type = self.MODULATION_TYPES[int(value)]
        except (ValueError, IndexError):
            self._modulation_type = value

    def _family(self) -> str:
        """ASK / FSK / PSK family of the configured type (GFSK is
        frequency-based, OQPSK phase-based)."""
        for family in _FAMILIES:
            if family in self.modulation_type:
                return family
        return ""

    @property
    def is_binary_modulation(self):
        return self.bits_per_symbol == 1

    @property
    def is_amplitude_based(self):
        return self._family() == "ASK"

    @property
    def is_frequency_based(self):
        return self._family() == "FSK"

    @property
    def is_phase_based(self):
        return self._family() == "PSK"

    @property
    def bits_per_symbol(self):
        return self._bits_per_symbol

    @bits_per_symbol.setter
    def bits_per_symbol(self, value):
        value = int(value)
        if value != self._bits_per_symbol:
            self._bits_per_symbol = value
            self.parameters = array.array("f", [0] * self.modulation_order)

    @property
    def modulation_order(self):
        return 2 ** self.bits_per_symbol

    @property
    def sample_rate(self):
        return (self._sample_rate if self._sample_rate is not None
                else self.default_sample_rate)

    @sample_rate.setter
    def sample_rate(self, value):
        self._sample_rate = value

    @property
    def display_bits(self) -> str:
        return "".join("1" if bit else "0" for bit in self.data)

    @display_bits.setter
    def display_bits(self, value: str):
        self.data = [bit == "1" for bit in value]

    @property
    def parameter_type_str(self) -> str:
        family = self._family()
        return (_FAMILIES[family][1] if family
                else "Unknown Modulation Type")

    # -- synthesis -------------------------------------------------------
    def modulate(self, data=None, pause=0, start=0, dtype=None, device=None) -> IQData:
        """IQ of ``data`` (default: the modulator's own bits), synthesized
        on ``device`` (default: the CUDA card)."""
        if pause < 0:
            raise ValueError(f"pause must not be negative, got {pause}")
        if data is None:
            data = self.data
        else:
            self.data = data

        if isinstance(data, str):
            data = array.array("B", map(int, data))
        elif not isinstance(data, (array.array, bytes, bytearray, np.ndarray)):
            data = array.array("B", (int(b) for b in data))

        if len(data) == 0:
            return IQData(None, np.float32, 0)

        dtype = dtype or self.get_dtype()
        a = self.carrier_amplitude * min_max_for_dtype(dtype)[1]

        parameters = np.asarray(self.parameters, dtype=np.float32)
        if self.modulation_type == "ASK":
            parameters = parameters * np.float32(a / 100)
        elif self.modulation_type == "PSK":
            parameters = parameters * np.float32(math.pi / 180)

        result = _modulate_kernel(
            np.ascontiguousarray(data, dtype=np.uint8).reshape(-1),
            self.samples_per_symbol,
            self.modulation_type,
            parameters,
            self.bits_per_symbol,
            a,
            self.carrier_freq_hz,
            self.carrier_phase_deg * (np.pi / 180),
            self.sample_rate,
            pause,
            start,
            dtype,
            self.gauss_bt,
            self.gauss_filter_width,
            device=device,
        )
        return IQData(result, skip_conversion=True)

    def _default_phases(self) -> np.ndarray:
        step = 360 / self.modulation_order
        phases = np.arange(step / 2, 360, step) - 180
        if self.modulation_type == "OQPSK":
            gray = [i ^ (i >> 1) for i in range(self.modulation_order)]
            phases = phases[gray]
        return phases

    def get_default_parameters(self) -> array.array:
        family = self._family()
        if not family:
            return None
        return array.array("f", _FAMILIES[family][2](self))

    def estimate_carrier_frequency(self, signal, protocol):
        """Estimate the carrier from the first message's sample range
        (Modulator.py:307-317)."""
        if len(protocol.messages) == 0:
            return None
        start, num_samples = protocol.get_samplepos_of_bitseq(0, 0, 0, 999999, False)
        num_samples = min(num_samples, int(1e6))
        return signal.estimate_frequency(start, start + num_samples, self.sample_rate)

    # -- persistence -----------------------------------------------------
    def to_xml(self, index: int = 0) -> ET.Element:
        root = ET.Element("modulator")
        for attr in self._XML_SCALARS:
            root.set(attr, str(getattr(self, attr)))
        root.set("samples_per_symbol", str(self.samples_per_symbol))
        root.set("modulation_type", self._modulation_type)
        root.set("bits_per_symbol", str(self._bits_per_symbol))
        root.set("sample_rate",
                 "" if self._sample_rate is None else str(self._sample_rate))
        root.set("param_for_zero", "")  # legacy field
        root.set("parameters", ",".join(map(str, self.parameters)))
        root.set("index", str(index))
        return root

    @staticmethod
    def from_xml(tag: ET.Element) -> "Modulator":
        result = Modulator("")
        for attr, parse in Modulator._XML_SCALARS.items():
            raw = tag.get(attr)
            if raw:
                setattr(result, attr, parse(raw))
        if tag.get("modulation_type"):
            result.modulation_type = tag.get("modulation_type")
        if tag.get("bits_per_symbol"):
            result.bits_per_symbol = int(tag.get("bits_per_symbol"))
        # current name first, then the pre-bits-per-symbol legacy name
        for sps_attr in ("samples_per_symbol", "samples_per_bit"):
            if tag.get(sps_attr):
                result.samples_per_symbol = int(float(tag.get(sps_attr)))
        rate = tag.get("sample_rate")
        result.sample_rate = (float(rate) if rate and rate != "None" else None)
        if tag.get("parameters"):
            result.parameters = array.array(
                "f", (float(p) for p in tag.get("parameters").split(",")))
        elif tag.get("param_for_zero") and tag.get("param_for_one"):
            # legacy two-symbol format
            try:
                result.parameters = array.array(
                    "f", (float(tag.get("param_for_zero")),
                          float(tag.get("param_for_one"))))
            except ValueError:
                pass
        return result

    @staticmethod
    def modulators_to_xml_tag(modulators: list) -> ET.Element:
        root = ET.Element("modulators")
        for i, mod in enumerate(modulators):
            root.append(mod.to_xml(i))
        return root

    @staticmethod
    def modulators_from_xml_tag(xml_tag: ET.Element) -> list:
        if xml_tag is None:
            return []
        if xml_tag.tag != "modulators":
            xml_tag = xml_tag.find("modulators")
        if xml_tag is None:
            return []
        return [Modulator.from_xml(tag) for tag in xml_tag.findall("modulator")]
