"""InsertSine: synthesize a complex sine and insert it into a signal
(headless core of urh/plugins/InsertSine/InsertSinePlugin.py)."""

from __future__ import annotations

import numpy as np

from urh_tpu_torch.core.iq import IQData


from urh_tpu_torch.plugins.manager import SignalEditorPlugin


class InsertSinePlugin(SignalEditorPlugin):
    def __init__(self):
        super().__init__(name="InsertSine")
        self.amplitude = 0.5
        self.frequency = 10e3
        self.phase = 0.0
        self.sample_rate = 1e6
        self.num_samples = int(1e6)

    def generate_sine_wave(self, dtype=np.float32) -> np.ndarray:
        """(num_samples, 2) IQ sine with the configured parameters."""
        t = np.arange(0, self.num_samples) / self.sample_rate
        arg = 2 * np.pi * self.frequency * t + self.phase
        wave = np.empty(len(arg), dtype=np.complex64)
        wave.real = np.cos(arg)
        wave.imag = np.sin(arg)
        return IQData(self.amplitude * wave).convert_to(dtype)

    def insert_into_signal(self, signal, position: int):
        """Insert the configured sine into a Signal at sample position."""
        wave = self.generate_sine_wave(dtype=signal.iq_array.dtype)
        signal.insert_data(position, wave)
        return signal
