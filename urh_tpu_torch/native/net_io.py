"""Python wrappers for the native TCP sample streaming."""

from __future__ import annotations

import ctypes

import numpy as np

from urh_tpu_torch.native.build import get_library
from urh_tpu_torch.native.ringbuffer import NativeRingBuffer


class NativeSampleReceiver:
    """TCP server streaming float32 IQ straight into a native ring buffer
    from a C++ thread (never holds the GIL)."""

    def __init__(self, ring: NativeRingBuffer, port: int = 0):
        self._lib = get_library()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self.ring = ring
        self._handle = self._lib.urh_net_rx_start(ring._addr, port)
        if not self._handle:
            raise OSError("could not start native receiver")

    @property
    def port(self) -> int:
        return int(self._lib.urh_net_rx_port(self._handle))

    @property
    def total_samples(self) -> int:
        return int(self._lib.urh_net_rx_total_samples(self._handle))

    @property
    def dropped_samples(self) -> int:
        return int(self._lib.urh_net_rx_dropped_samples(self._handle))

    def stop(self):
        if self._handle:
            self._lib.urh_net_rx_stop(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


def native_send_samples(host: str, port: int, samples: np.ndarray) -> int:
    """Blocking native send of (N, 2) float32 samples; returns samples sent."""
    lib = get_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    sent = lib.urh_net_send(host.encode(), port,
                            samples.ctypes.data_as(ctypes.c_void_p), len(samples))
    if sent < 0:
        raise OSError(f"native send to {host}:{port} failed")
    return int(sent)
