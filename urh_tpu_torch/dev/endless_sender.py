"""Endless-send mode: a TX device drained from shared memory.

Counterpart of urh/dev/EndlessSender.py:13-57. The sender owns exactly one
invariant: whatever `VirtualDevice` it currently wraps is in continuous-send
mode with a freshly sized shared-memory ring buffer attached. All of the
device/name mutation paths funnel through `_attach` so that invariant can't
be violated piecemeal.
"""

from __future__ import annotations

import numpy as np

from urh_tpu_torch.dev.virtual_device import Mode, VirtualDevice
from urh_tpu_torch.util import settings
from urh_tpu_torch.util.ringbuffer import RingBuffer


def _ring_capacity() -> int:
    # capacity in complex samples (8 bytes each) from the configured MB budget
    return int(settings.CONTINUOUS_BUFFER_SIZE_MB * 1e6) // 8


class EndlessSender:
    def __init__(self, backend_handler, name: str):
        self.ringbuffer: RingBuffer | None = None
        self._device: VirtualDevice | None = None
        self._attach(VirtualDevice(backend_handler=backend_handler, name=name,
                                   mode=Mode.send))

    def _attach(self, device: VirtualDevice) -> None:
        """Wrap `device` for continuous TX: new ring buffer, streaming on."""
        self._device = device
        self.ringbuffer = RingBuffer(_ring_capacity(), device.data_type)
        device.continuous_send_ring_buffer = self.ringbuffer
        device.is_send_continuous = True

    @property
    def device(self) -> VirtualDevice:
        return self._device

    @device.setter
    def device(self, value: VirtualDevice):
        self._attach(value)

    @property
    def device_name(self) -> str:
        return self._device.name

    @device_name.setter
    def device_name(self, value: str):
        if value != self._device.name:
            self._attach(VirtualDevice(
                backend_handler=self._device.backend_handler, name=value,
                mode=Mode.send))

    def start(self):
        self._device.num_sending_repeats = 0
        self._device.start()

    def stop(self):
        self._device.stop("EndlessSender stopped.")

    def push_data(self, data: np.ndarray):
        self.ringbuffer.push(data)
