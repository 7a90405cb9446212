"""Streaming TX synthesis: an endless IQ stream without materializing it.

Counterpart of the reference's continuous-modulation stage
(urh/signalprocessing/ContinuousModulator.py:70-99) but built around a
*playlist* architecture instead of shipping live protocol objects to the
worker:

  1. The parent resolves each message ONCE into a plain-array playlist
     entry ``(bits u8[], pause, modulator config)`` — encoding chains run
     a single time even when the stream repeats forever, and the spawned
     child never has to unpickle Message/Modulator object graphs.
  2. A module-level worker (`_synthesis_worker`) cycles the playlist,
     synthesizes one message per iteration on the device it was given
     (default: the CUDA card, in a CUDA context of the child's own), and
     pushes it into the shared-memory ring buffer that the device TX
     process drains.
  3. Backpressure is an ``Event.wait`` on the stop flag, so a stop request
     interrupts a full-buffer wait immediately (no sleep-poll loop).
"""

from __future__ import annotations

import multiprocessing
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np

from urh_tpu_torch.core.iq import resolve_device
from urh_tpu_torch.dsp.modulator import Modulator
from urh_tpu_torch.util import settings
from urh_tpu_torch.util.logging import logger
from urh_tpu_torch.util.ringbuffer import RingBuffer

# a child forked after the parent made a CUDA context cannot use CUDA, and
# fork is unsafe in a threaded parent: always spawn children
_mp = multiprocessing.get_context("spawn")

# how long a full-buffer wait blocks before re-checking capacity
_BACKPRESSURE_S = 0.1


@dataclass(frozen=True)
class PlaylistEntry:
    """One pre-resolved message: everything synthesis needs, arrays only."""

    bits: np.ndarray          # u8 encoded bits
    pause: int                # trailing pause in samples
    modulator_xml: str        # serialized modulator config (picklable, stable)


def _resolve_playlist(messages, modulators) -> list[PlaylistEntry]:
    """Run every message's encoding chain once, up front, in the parent."""
    entries = []
    for msg in messages:
        # clamp stale indices like GeneratorBackend._modulator_of_message
        index = msg.modulator_index
        if not 0 <= index < len(modulators):
            index = 0
        mod = modulators[index]
        entries.append(PlaylistEntry(
            bits=np.asarray(msg.encoded_bits, dtype=np.uint8),
            pause=int(msg.pause),
            modulator_xml=ET.tostring(mod.to_xml()).decode()))
    return entries


def _synthesis_worker(playlist, ring_buffer, cursor, stop_flag, repeats,
                      dtype=None, device=None):
    """Child-process entry: cycle the playlist into the ring buffer.

    `cursor` is a shared value holding the playlist position so the parent
    can display progress and a restart resumes mid-playlist.  ``dtype``
    overrides the synthesis dtype (it must match the ring buffer's — the
    TX device's wire format, e.g. float32 for the Network SDR).
    ``device`` is the torch device synthesis runs on, as a string
    ("cuda:0", "cpu"; None: the CUDA card); where CUDA fails in the child,
    it raises.
    """
    modulators = [Modulator.from_xml(ET.fromstring(e.modulator_xml))
                  for e in playlist]

    def push_backpressured(block) -> bool:
        """Push in ring-capacity slices (a message larger than the ring
        would otherwise never fit); False = stop requested."""
        step = max(1, ring_buffer.size // 2)
        for lo in range(0, len(block), step):
            piece = block[lo:lo + step]
            while not ring_buffer.will_fit(len(piece)):
                if stop_flag.wait(_BACKPRESSURE_S):
                    return False
            ring_buffer.push(piece)
        return True

    remaining = repeats if repeats > 0 else None
    while remaining is None or remaining > 0:
        while cursor.value < len(playlist):
            if stop_flag.is_set():
                return
            entry = playlist[cursor.value]
            iq = modulators[cursor.value].modulate(
                start=0, data=entry.bits, pause=entry.pause, dtype=dtype, device=device)
            if not push_backpressured(iq.data):
                return
            cursor.value += 1
        cursor.value = 0
        if remaining is not None:
            remaining -= 1


class ContinuousModulator:
    """Owns the worker process + shared ring buffer for one TX stream."""

    def __init__(self, messages, modulators, num_repeats=-1, dtype=None, device=None):
        self.messages = messages
        # resolved here, in the parent: the child gets it as a string
        self.device = str(resolve_device(device))
        self.modulators = modulators
        self.num_repeats = num_repeats  # <= 0 = forever
        self.dtype = dtype if dtype is not None else Modulator.get_dtype()

        self.ring_buffer = RingBuffer(
            int(settings.CONTINUOUS_BUFFER_SIZE_MB * 1e6) // 8,
            dtype=self.dtype)
        self.current_message_index = _mp.Value("L", 0)
        self._stop_flag = _mp.Event()
        self.process = self._spawn()

    def _spawn(self) -> multiprocessing.Process:
        playlist = _resolve_playlist(self.messages, self.modulators)
        return _mp.Process(
            target=_synthesis_worker,
            args=(playlist, self.ring_buffer, self.current_message_index,
                  self._stop_flag, self.num_repeats, self.dtype, self.device),
            daemon=True)

    @property
    def is_running(self) -> bool:
        return self.process.is_alive()

    def start(self):
        self._stop_flag.clear()
        try:
            self.process = self._spawn()
            self.process.start()
        except RuntimeError as e:
            logger.exception(e)

    def stop(self, clear_buffer=True):
        self._stop_flag.set()
        if self.process.is_alive():
            try:
                self.process.join(1.5)
            except RuntimeError as e:
                logger.exception(e)
            if self.process.is_alive():
                self.process.terminate()
        if clear_buffer:
            self.ring_buffer.clear()
        logger.debug("Stopped continuous modulation")
