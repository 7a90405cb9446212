"""FlipperZeroSub: export messages as Flipper Zero SubGhz RAW files.

Counterpart of urh/plugins/FlipperZeroSub/FlipperZeroSubPlugin.py, rebuilt
around array code: bit runs come from one vectorized run-length encode over
the concatenated bit plane (np.diff boundary detection) instead of a
per-bit Python loop, and the .sub text is assembled from a template +
chunked RAW_Data lines.
"""

from __future__ import annotations

import numpy as np

from urh_tpu_torch.plugins.manager import SDRPlugin
from urh_tpu_torch.util.logging import logger

# (modulation, min bandwidth/deviation threshold) -> (FuriHal preset, bw)
# first matching row wins; thresholds are in the units the reference UI uses
_PRESETS = (
    ("ASK", 500, "FuriHalSubGhzPresetOok650Async", 650),
    ("ASK", None, "FuriHalSubGhzPresetOok270Async", 270),
    ("FSK", 20, "FuriHalSubGhzPreset2FSKDev476Async", 47.6),
    ("FSK", None, "FuriHalSubGhzPreset2FSKDev238Async", 2.38),
    ("GFSK", None, "FuriHalSubGhzPresetGFSK9_99KbAsync", 19.04),
    ("PSK", None, "FuriHalSubGhzPresetCustom", 238),
)
_FALLBACK = ("FuriHalSubGhzPresetOok650Async", 650)

MAX_VALUES_PER_LINE = 512


def signed_runs(bits: np.ndarray) -> np.ndarray:
    """Run-length encode a bit vector into Flipper's signed-duration form:
    +count for a run of ones, -count for a run of zeros."""
    bits = np.asarray(bits, dtype=np.int8)
    if bits.size == 0:
        return np.zeros(0, dtype=np.int64)
    edges = np.flatnonzero(np.diff(bits))
    starts = np.concatenate(([0], edges + 1))
    ends = np.concatenate((edges + 1, [bits.size]))
    lengths = (ends - starts).astype(np.int64)
    signs = np.where(bits[starts] == 1, 1, -1)
    return signs * lengths


class FlipperZeroSubPlugin(SDRPlugin):
    def __init__(self):
        super().__init__(name="FlipperZeroSub")
        self.filetype = "Flipper SubGhz RAW File"
        self.version = 1
        self.protocol = "RAW"
        self.max_values_per_line = MAX_VALUES_PER_LINE

    def get_furi_hal_string(self, modulation_type, given_bandwidth_deviation=0):
        """Map a modulation to the Flipper FuriHal preset via the table."""
        for mod, threshold, preset, bw in _PRESETS:
            if mod != modulation_type:
                continue
            if threshold is None or given_bandwidth_deviation > threshold:
                return preset, bw
        return _FALLBACK

    # reference-compatible camelCase alias
    getFuriHalString = get_furi_hal_string

    def render_sub(self, frequency: int, preset: str,
                   durations: np.ndarray) -> str:
        """Assemble the full .sub text for one RAW export."""
        header = (f"Filetype: {self.filetype}\n"
                  f"Version: {self.version}\n"
                  f"Frequency: {frequency}\n"
                  f"Preset: {preset}\n"
                  f"Protocol: {self.protocol}")
        lines = [header]
        per_line = self.max_values_per_line
        for i in range(0, len(durations), per_line):
            chunk = " ".join(str(v) for v in durations[i:i + per_line])
            lines.append(f"RAW_Data: {chunk}")
        return "\n".join(lines) + "\n"

    def write_sub_file(self, filename, messages, sample_rates, modulators,
                       project_manager) -> bool:
        if not messages:
            logger.debug("empty signal")
            return False

        sps = messages[0].samples_per_symbol
        preset, _ = self.get_furi_hal_string(
            modulators[messages[0].modulator_index].modulation_type, 1000)
        runs = np.concatenate([
            signed_runs(np.asarray(list(msg), dtype=np.int8))
            for msg in messages]) if messages else np.zeros(0, np.int64)

        text = self.render_sub(int(project_manager.device_conf["frequency"]),
                               preset, runs * int(sps))
        try:
            with open(filename, "w") as f:
                f.write(text)
        except OSError as e:
            logger.error(f"could not open {filename} for writing: {e}")
            return False
        return True
