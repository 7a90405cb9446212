"""Headless generator backend: protocol table -> contiguous IQ buffer.

Counterpart of the modulation-buffer path in
urh/controller/GeneratorTabController.py:121-129 (total sample count),
:490-509 (buffer allocation by configured dtype) and :511-535
(sequential modulation of each message into the buffer; pauses are
left as the zeros the buffer was initialized with).  Synthesis runs on
``device`` (default: the CUDA card).
"""

from __future__ import annotations

import numpy as np

from urh_tpu_torch.core.iq import IQData, resolve_device
from urh_tpu_torch.dsp.modulator import Modulator
from urh_tpu_torch.util.logging import logger


class GeneratorBackend:
    """Drives modulation of a ProtocolAnalyzerContainer's message table."""

    def __init__(self, container, modulators=None, device=None):
        self.container = container
        self.device = resolve_device(device)
        self.modulators = modulators if modulators is not None else [Modulator("Modulation")]
        self.modulation_msg_indices = []

    def _modulator_of_message(self, message) -> Modulator:
        if message.modulator_index > len(self.modulators) - 1:
            message.modulator_index = 0
        return self.modulators[message.modulator_index]

    def _message_samples(self, msg) -> int:
        """Exact modulated length of one message: mirrors modulate()'s
        total_samples = (num_bits // bits_per_symbol) * sps + pause,
        including the OQPSK staggering pad (dsp/modulate.py:228-235)."""
        modulator = self._modulator_of_message(msg)
        num_bits = len(msg.encoded_bits)
        if modulator.modulation_type == "OQPSK":
            num_bits += 2
        return (num_bits // modulator.bits_per_symbol
                ) * modulator.samples_per_symbol + int(msg.pause)

    @property
    def total_modulated_samples(self) -> int:
        return sum(self._message_samples(msg)
                   for msg in self.container.messages)

    def prepare_modulation_buffer(self, total_samples: int = None) -> IQData:
        if total_samples is None:
            total_samples = self.total_modulated_samples
        dtype = Modulator.get_dtype()
        n = 2 if dtype == np.int8 else 4 if dtype == np.int16 else 8
        logger.debug("Allocating {0:.2f}MB for modulated samples".format(
            total_samples * n / (1024 ** 2)))
        return IQData(None, dtype=dtype, n=total_samples)

    def modulate_data(self, buffer: IQData) -> IQData:
        """Modulate every message into ``buffer`` (already zeroed); pauses
        need no explicit synthesis."""
        self.modulation_msg_indices.clear()
        pos = 0
        for message in self.container.messages:
            modulator = self._modulator_of_message(message)
            modulated = modulator.modulate(start=0, data=message.encoded_bits, pause=0,
                                           device=self.device)
            buffer[pos: pos + len(modulated)] = modulated
            pos += len(modulated) + message.pause
            self.modulation_msg_indices.append(pos)
        return buffer

    def generate(self) -> IQData:
        buffer = self.prepare_modulation_buffer()
        return self.modulate_data(buffer)
