"""Python wrapper for the native lock-free SPSC ring buffer.

API-compatible with urh_tpu_torch.util.ringbuffer.RingBuffer; the storage
lives in multiprocessing shared memory so producer and consumer can be
different processes, and all index arithmetic runs in C++ without the
GIL.
"""

from __future__ import annotations

import ctypes
from multiprocessing import shared_memory

import numpy as np

from urh_tpu_torch.native.build import get_library


class NativeRingBuffer:
    def __init__(self, size: int, dtype=np.float32, shm_name: str = None):
        if np.dtype(dtype) != np.float32:
            raise ValueError("native ring buffer stores float32 IQ samples")
        lib = get_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.size = size
        self.dtype = np.dtype(np.float32)

        nbytes = int(lib.urh_ring_size_bytes(size))
        if shm_name is None:
            self._shm = shared_memory.SharedMemory(create=True, size=nbytes)
            self._owner = True
            lib.urh_ring_init(self._addr, size)
        else:
            self._shm = shared_memory.SharedMemory(name=shm_name)
            self._owner = False

    @property
    def shm_name(self) -> str:
        return self._shm.name

    @property
    def _addr(self):
        return ctypes.addressof(ctypes.c_char.from_buffer(self._shm.buf))

    def __len__(self):
        return int(self._lib.urh_ring_len(self._addr))

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    @property
    def space_left(self):
        return int(self._lib.urh_ring_space(self._addr))

    def will_fit(self, number_values: int) -> bool:
        return number_values <= self.space_left

    def push(self, values: np.ndarray):
        values = np.ascontiguousarray(values, dtype=np.float32)
        n = len(values)
        pushed = int(self._lib.urh_ring_push(
            self._addr, values.ctypes.data_as(ctypes.c_void_p), n))
        if pushed < n:
            raise ValueError("too much data to push to NativeRingBuffer")

    def pop(self, number: int, ensure_even_length=False) -> np.ndarray:
        if number < 0:
            number = len(self)
        if ensure_even_length:
            number -= number % 2
        if number == 0:
            return np.array([], dtype=np.float32)
        out = np.empty((number, 2), dtype=np.float32)
        popped = int(self._lib.urh_ring_pop(
            self._addr, out.ctypes.data_as(ctypes.c_void_p), number))
        return out[:popped]

    def clear(self):
        self._lib.urh_ring_clear(self._addr)

    def close(self):
        self._shm.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
