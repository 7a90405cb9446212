"""Live protocol sniffing: device RX -> streaming device demod -> messages.

PyTorch port of urh_tpu.protocol.sniffer, the counterpart of
urh/signalprocessing/ProtocolSniffer.py, rebuilt around
:class:`urh_tpu_torch.protocol.stream.StreamDemodulator`: there is no
host-side power gate or burst buffer here — every received chunk goes
straight to the stream block kernel (ASK, FSK) or the Costas loop kernel
(PSK) on the compute device, and the sniffer only handles run-level
segments coming back (plus message assembly, decoding and persistence).
Noise adaptation, automatic center detection, FSK halo and PSK Costas
state all live in the stream core and chain exactly across chunk
boundaries.

``device`` names the SDR (as in urh_tpu); ``compute_device`` is the torch
device the stream runs on (default: the CUDA card).
"""

from __future__ import annotations

import os
import time
from collections import deque
from datetime import datetime
from threading import Thread

import numpy as np

from urh_tpu_torch.core.iq import IQData, resolve_device
from urh_tpu_torch.core.signal import Signal
from urh_tpu_torch.dev.backend_handler import BackendHandler, Backends
from urh_tpu_torch.dev.virtual_device import Mode, VirtualDevice
from urh_tpu_torch.dsp.demod import DemodParams
from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer
from urh_tpu_torch.protocol.message import Message
from urh_tpu_torch.protocol.stream import StreamDemodulator
from urh_tpu_torch.util.events import Event
from urh_tpu_torch.util.metrics import metrics, now_ns

POLL_INTERVAL_S = 0.01
# drains remembered for sniffer.emit_wait: a message is emitted within a
# few drains of its last sample
DRAINS_KEPT = 64
# how long stop() waits for the poll thread to leave a feed in flight
STOP_JOIN_S = 60.0


class ProtocolSniffer(ProtocolAnalyzer):
    def __init__(self, samples_per_symbol: int, center: float, center_spacing: float,
                 noise: float, tolerance: int, modulation_type: str,
                 bits_per_symbol: int, device: str, backend_handler: BackendHandler,
                 network_raw_mode=False, device_ip: str = None, compute_device=None):
        self.compute_device = resolve_device(compute_device)
        signal = Signal("", "LiveSignal", device=self.compute_device)
        signal.samples_per_symbol = samples_per_symbol
        signal.center = center
        signal.center_spacing = center_spacing
        signal.noise_threshold = noise
        signal.tolerance = tolerance
        signal.silent_set_modulation_type(modulation_type)
        signal.bits_per_symbol = bits_per_symbol
        ProtocolAnalyzer.__init__(self, signal)

        self.started = Event()
        self.stopped = Event()
        self.message_sniffed = Event(int)

        self.network_raw_mode = network_raw_mode
        self.backend_handler = backend_handler
        self.device_ip = device_ip
        self.rcv_device = self._make_device(device)

        self.sniff_thread = Thread(target=self._poll_loop, daemon=True)

        self._stream = None
        self.drain_position = 0   # ring index up to which samples were fed
        # the latest drains' (stream samples fed before and after, start
        # ns), oldest first, and whether a drain is feeding: for
        # sniffer.emit_wait
        self._drains = deque(maxlen=DRAINS_KEPT)
        self._draining = False
        self.adaptive_noise = False
        self.automatic_center = False

        self.is_running = False
        self.store_messages = True

        self._sniff_file = ""
        self._store_data = True

    # -- device wiring -----------------------------------------------------
    def _make_device(self, name: str) -> VirtualDevice:
        dev = VirtualDevice(self.backend_handler, name, Mode.receive,
                            device_ip=self.device_ip,
                            resume_on_full_receive_buffer=True,
                            raw_mode=self.network_raw_mode)
        dev.started.connect(self.started.emit)
        dev.stopped.connect(self.stopped.emit)
        self.signal.iq_array = IQData(None, dev.data_type, 0)
        return dev

    @property
    def device_name(self):
        return self.rcv_device.name

    @device_name.setter
    def device_name(self, value: str):
        if value != self.rcv_device.name:
            self.rcv_device.free_data()
            self.rcv_device = self._make_device(value)

    # -- demod configuration ----------------------------------------------
    def _make_stream(self) -> StreamDemodulator:
        s = self.signal
        params = DemodParams(
            modulation=s.modulation_type,
            samples_per_symbol=s.samples_per_symbol,
            center=s.center,
            center_spacing=s.center_spacing,
            noise_threshold=s.noise_threshold,
            tolerance=s.tolerance,
            bits_per_symbol=s.bits_per_symbol,
            sample_rate=self.rcv_device.sample_rate or 1e6,
        )
        return StreamDemodulator(params,
                                 adaptive_noise=self.adaptive_noise,
                                 automatic_center=self.automatic_center,
                                 device=self.compute_device)

    # -- text output -------------------------------------------------------
    def decoded_to_string(self, view: int, start=0, include_timestamps=True):
        return "\n".join(self.message_to_string(msg, view, include_timestamps)
                         for msg in self.messages[start:])

    def message_to_string(self, message: Message, view: int, include_timestamps=True):
        parts = []
        if include_timestamps:
            stamp = datetime.fromtimestamp(message.timestamp)
            parts.append(stamp.strftime("[%Y-%m-%d %H:%M:%S.%f]"))
        parts.append(message.view_to_string(view, decoded=True, show_pauses=False))
        return " ".join(parts)

    @property
    def sniff_file(self):
        return self._sniff_file

    @sniff_file.setter
    def sniff_file(self, val):
        self._sniff_file = val
        if self._sniff_file:
            self._store_data = False

    # -- live loop ---------------------------------------------------------
    def sniff(self):
        self.is_running = True
        self._stream = self._make_stream()
        self._drains.clear()
        self.rcv_device.start()
        self.sniff_thread = Thread(target=self._poll_loop, daemon=True)
        self.sniff_thread.start()

    def _poll_loop(self):
        self.drain_position = 0
        while self.is_running:
            time.sleep(POLL_INTERVAL_S)
            if self.rcv_device.is_raw_mode:
                self.drain_position = self._drain_ring(self.drain_position)
            elif self.rcv_device.backend == Backends.network:
                self._drain_bit_messages()
            self._persist_pending()

    def _drain_ring(self, ring_pos: int) -> int:
        """Pull new samples out of the device's ring buffer and hand them
        to the streaming demodulator, as a ``sniffer.drain`` span, after a
        ``sniffer.ring_wait`` span from the first write since the previous
        drain to the drain's start."""
        write_pos, first_commit = self.rcv_device.take_receive_index()
        if write_pos == ring_pos:
            return ring_pos
        ring = self.rcv_device.data
        n = write_pos - ring_pos if ring_pos <= write_pos else len(ring) - ring_pos + write_pos
        with metrics.span("sniffer.drain", samples=n) as drain:
            if first_commit is not None:
                metrics.add("sniffer.ring_wait", first_commit, drain.start_ns)
            if ring_pos <= write_pos:
                chunk = np.asarray(ring[ring_pos:write_pos])
            else:
                chunk = np.concatenate((np.asarray(ring[ring_pos:]),
                                        np.asarray(ring[:write_pos])))
            # what _emit_segments times a message's sniffer.emit_wait from
            fed = self._stream._fed
            self._drains.append((fed, fed + len(chunk), drain.start_ns))
            self._draining = True
            try:
                self._ingest(chunk)
            finally:
                self._draining = False
        return write_pos

    def _ingest(self, chunk: np.ndarray):
        if len(chunk) == 0:
            return
        with metrics.measure("sniffer.demodulate", len(chunk)):
            # no next chunk is in hand: the chunk's own bundle is consumed
            # now, so a message leaves in the drain that fed its end
            segments = self._stream.feed(chunk)
            segments += self._stream.settle()
        self._emit_segments(segments)
        if self.adaptive_noise:
            self.signal.noise_threshold = self._stream.noise_threshold

    def _emit_segments(self, segments):
        """Messages of the segments, each announced by ``message_sniffed``;
        inside a drain, each also records a ``sniffer.emit_wait`` span from
        the start of the drain that fed its last sample."""
        sps = self.signal.samples_per_symbol
        now = time.time()
        fed = self._stream._fed
        rate = self.rcv_device.sample_rate or 1e6
        for seg in segments:
            bit_data, pauses, bit_sample_pos = self._ppseq_to_bits(
                seg.ppseq, sps, self.signal.bits_per_symbol,
                write_bit_sample_pos=True)
            for i, (bits, pause) in enumerate(zip(bit_data, pauses)):
                stamp = now - (fed - seg.start_sample - bit_sample_pos[i][0]) / rate
                msg = Message(bits, pause, samples_per_symbol=sps,
                              message_type=self.default_message_type,
                              decoder=self.decoder, timestamp=stamp)
                self.messages.append(msg)
                emitted = now_ns()
                self.message_sniffed.emit(len(self.messages) - 1)
                if self._draining:
                    # the message ends where its closing pause starts
                    self._record_emit_wait(seg.start_sample + bit_sample_pos[i][len(bits)] - 1,
                                           emitted)

    def _record_emit_wait(self, last_sample: int, emitted: int):
        for fed_before, fed_after, start in self._drains:
            if fed_before <= last_sample < fed_after:
                metrics.add("sniffer.emit_wait", start, emitted)
                return

    def _drain_bit_messages(self):
        """Bit-mode network device: lines of bits arrive pre-demodulated."""
        for bit_str in list(self.rcv_device.data):
            msg = Message.from_plain_bits_str(bit_str)
            msg.decoder = self.decoder
            self.messages.append(msg)
            self.message_sniffed.emit(len(self.messages) - 1)
        self.rcv_device.free_data()  # avoid double-storing bits

    def _persist_pending(self):
        if self.sniff_file and not os.path.isdir(self.sniff_file):
            lines = self.plain_bits_str
            if lines:
                with open(self.sniff_file, "a") as f:
                    f.write("\n".join(lines) + "\n")
        if not self._store_data:
            self.messages.clear()

    def stop(self):
        """Stop the device and the poll thread, then flush the stream.  The
        thread is joined until it has left any feed in flight (urh_tpu
        waits 0.1 s and flushes regardless), so the stream's buffers are
        never used by two threads; RuntimeError if it is still running
        after STOP_JOIN_S."""
        self.is_running = False
        self.rcv_device.stop("Stopping receiving due to user interaction")
        if self.sniff_thread.is_alive():
            self.sniff_thread.join(STOP_JOIN_S)
        if self.sniff_thread.is_alive():
            raise RuntimeError(f"sniff thread still running {STOP_JOIN_S} s after stop()")
        if self._stream is not None:
            self._emit_segments(self._stream.flush())

    def clear(self):
        self.messages.clear()
