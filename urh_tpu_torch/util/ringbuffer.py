"""SPSC ring buffer over shared memory for continuous TX/RX streaming.

Counterpart of urh/util/RingBuffer.py: complex (N, 2) samples in a
multiprocessing shared Array so a producer process (e.g. the continuous
modulator) and a consumer process (device TX) stream without copies
through the Python heap.  Internally only (read cursor, fill count) are
stored — the write cursor is derived — and both push and pop run
through one circular-copy helper.  A C++ lock-free variant for the
native IO path lives in urh_tpu_torch/native.
"""

from __future__ import annotations

import multiprocessing

# spawn context: these objects are shared into spawned device processes
_mp = multiprocessing.get_context("spawn")

import numpy as np

_TYPECODES = {np.dtype(np.uint8): "B", np.dtype(np.int8): "b",
              np.dtype(np.int16): "h", np.dtype(np.uint16): "H",
              np.dtype(np.float32): "f", np.dtype(np.float64): "d"}


class RingBuffer:
    def __init__(self, size: int, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        self.size = size
        self._plane = _mp.Array(_TYPECODES[self.dtype], 2 * size)
        self._read = _mp.Value("L", 0)    # sample index of the oldest entry
        self._fill = _mp.Value("L", 0)    # live sample count

    # -- state -------------------------------------------------------------
    def __len__(self):
        return self._fill.value

    @property
    def left_index(self):
        return self._read.value

    @left_index.setter
    def left_index(self, value):
        self._read.value = value % self.size

    @property
    def right_index(self):
        return (self._read.value + self._fill.value) % self.size

    @right_index.setter
    def right_index(self, value):
        # kept for API parity: repositioning the write cursor redefines
        # the fill count relative to the read cursor
        self._fill.value = (value - self._read.value) % self.size

    @property
    def is_empty(self) -> bool:
        return self._fill.value == 0

    @property
    def space_left(self):
        return self.size - self._fill.value

    def will_fit(self, number_values: int) -> bool:
        return number_values <= self.space_left

    def clear(self):
        self._read.value = 0
        self._fill.value = 0

    # -- storage -----------------------------------------------------------
    @property
    def data(self):
        return np.frombuffer(self._plane.get_obj(),
                             dtype=self.dtype).reshape(-1, 2)

    @property
    def view_data(self):
        """Flattened scalar view rotated so the live region leads."""
        left = self.left_index
        right = left + len(self)
        if left > right:
            left, right = right, left
        flat = self.data.flatten()
        return np.concatenate((flat[left:right], flat[right:], flat[:left]))

    def _copy_circular(self, storage, cursor: int, n: int, src=None, dst=None):
        """Copy n sample rows to/from the ring starting at ``cursor``,
        split into the contiguous tail plus the wrapped head."""
        tail = min(n, self.size - cursor)
        if src is not None:  # writing into the ring
            storage[cursor:cursor + tail] = src[:tail]
            storage[:n - tail] = src[tail:]
        else:                # reading out of the ring
            dst[:tail] = storage[cursor:cursor + tail]
            dst[tail:] = storage[:n - tail]

    def push(self, values):
        """Push (N, 2) values; raises ValueError if they do not fit."""
        n = len(values)
        if not self.will_fit(n):
            raise ValueError("too much data to push to RingBuffer")
        with self._plane.get_lock():
            self._copy_circular(self.data, self.right_index, n, src=values)
            self._fill.value += n

    def pop(self, number: int, ensure_even_length=False) -> np.ndarray:
        """Pop up to ``number`` samples (all remaining when negative)."""
        if ensure_even_length:
            number -= number % 2
        if self.is_empty or number == 0:
            return np.array([], dtype=self.dtype)
        number = len(self) if number < 0 else min(number, len(self))

        out = np.empty((number, 2), dtype=self.dtype)
        with self._plane.get_lock():
            self._copy_circular(self.data, self.left_index, number, dst=out)
            self._read.value = (self._read.value + number) % self.size
            self._fill.value -= number
        return out
