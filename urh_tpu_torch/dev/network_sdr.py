"""Network SDR: TCP loopback sample/bit streaming device.

Counterpart of urh/plugins/NetworkSDRInterface (sans GUI), restructured
around composable pieces instead of the reference's monolithic handler
methods:

* wire formats are *decoder objects* (`IQStreamDecoder`, `BitLineDecoder`)
  that turn an incoming byte stream into payloads incrementally, holding
  partial frames between socket reads;
* the receive side is a thin socketserver handler: drain socket ->
  decoder -> sink;
* every send mode (one-shot raw, continuous ring-buffer raw, bit
  messages) is a generator of ``(bytes, sleep_after)`` steps consumed by
  one shared transmission driver.

This device doubles as the hardware-free fake SDR for pipeline and
simulator tests, exactly as in the reference test strategy
(SURVEY.md section 4).
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time

import numpy as np

from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.plugins.manager import SDRPlugin
from urh_tpu_torch.util import settings
from urh_tpu_torch.util.events import Event
from urh_tpu_torch.util.metrics import metrics, now_ns
from urh_tpu_torch.util.ringbuffer import RingBuffer

RECV_CHUNK = 65536


class IQStreamDecoder:
    """Byte stream -> complete (n, 2) float32 sample frames.

    Bytes that do not yet form a whole sample stay buffered until the
    next read."""

    def __init__(self, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        self.frame_bytes = 2 * self.dtype.itemsize
        self._partial = b""

    def push(self, data: bytes) -> np.ndarray:
        buf = self._partial + data
        whole = len(buf) - len(buf) % self.frame_bytes
        self._partial = buf[whole:]
        samples = np.frombuffer(buf[:whole], dtype=self.dtype)
        return samples.reshape(-1, 2)


class BitLineDecoder:
    """Byte stream -> '0'/'1' strings, one per newline-terminated line."""

    def __init__(self):
        self._partial = b""

    def push(self, data: bytes) -> list:
        buf = self._partial + data
        *lines, self._partial = buf.split(b"\n")
        return [bits_from_bytes(line) for line in lines if line]

    def finish(self) -> list:
        tail, self._partial = self._partial, b""
        return [bits_from_bytes(tail)] if tail else []


def bits_from_bytes(raw: bytes) -> str:
    """Packed bytes -> MSB-first bit string."""
    if not raw:
        return ""
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))
    return "".join(map(str, bits.tolist()))


def bytes_from_bits(bits: str) -> bytes:
    """MSB-first bit string -> packed bytes (zero-padded to a byte)."""
    arr = np.frombuffer(bits.encode(), np.uint8) - ord("0")
    return np.packbits(arr).tobytes()


class SampleSink:
    """Writes decoded sample frames into the shared receive buffer,
    restarting from the top when a write would run past the end (the
    reference's wrap rule for resumable receive buffers).  Counts its
    writes, samples and wraps (``ring.commits``, ``ring.samples``,
    ``ring.wraps`` in :data:`~urh_tpu_torch.util.metrics.metrics`) and
    stamps the first write after each :meth:`take`."""

    def __init__(self, buffer: IQData):
        self.buffer = buffer
        self.write_index = 0
        self._first_commit_ns = None  # metrics.now_ns() of the first write since take()
        self._lock = threading.Lock()

    def __call__(self, frames: np.ndarray):
        n = len(frames)
        if n == 0:
            return
        wrapped = self.write_index + n >= len(self.buffer)
        if wrapped:
            self.write_index = 0
        self.buffer[self.write_index:self.write_index + n] = frames
        with self._lock:
            self.write_index += n
            if self._first_commit_ns is None:
                self._first_commit_ns = now_ns()
        metrics.count({"ring.commits": 1, "ring.samples": n, "ring.wraps": int(wrapped)})

    def take(self) -> tuple:
        """-> (write index, when the first write since the previous take
        committed, or None), read together."""
        with self._lock:
            first, self._first_commit_ns = self._first_commit_ns, None
            return self.write_index, first


class _ReceiveHandler(socketserver.BaseRequestHandler):
    """One connection: drain fully, emitting payloads incrementally."""

    def handle(self):
        decoder = self.server.make_decoder()
        sink = self.server.sink
        while True:
            data = self.request.recv(RECV_CHUNK)
            if not data:
                break
            sink(decoder.push(data))
        if hasattr(decoder, "finish"):
            sink(decoder.finish())


class NetworkSDRInterfacePlugin(SDRPlugin):
    DATA_TYPE = np.float32
    NETWORK_SDR_NAME = "Network SDR"

    def __init__(self, raw_mode=False, resume_on_full_receive_buffer=False,
                 spectrum=False, sending=False):
        super().__init__(name="NetworkSDRInterface")
        self.client_ip = settings.read("network_sdr_client_ip", "127.0.0.1", str)
        self.server_ip = ""
        self.client_port = settings.read("network_sdr_client_port", 2222, int)
        self.server_port = settings.read("network_sdr_server_port", 4444, int)

        self.raw_mode = raw_mode
        self.is_in_spectrum_mode = spectrum
        self.resume_on_full_receive_buffer = resume_on_full_receive_buffer

        self.samples_to_send = None       # set by VirtualDevice
        self.sending_repeats = 1          # raw mode only; <= 0 means forever
        self.current_sent_sample = 0
        self.current_sending_repeat = 0
        self.sending_is_continuous = False
        self.continuous_send_ring_buffer = None
        self.num_samples_to_send = None
        self._is_sending = False
        self._interrupt = False

        # events replacing the Qt signals
        self.sending_status_changed = Event(bool)
        self.sending_stop_requested = Event()
        self.current_send_message_changed = Event(int)
        self.send_connection_established = Event()
        self.receive_server_started = Event()
        self.error_occurred = Event(str)

        self.server = None
        self._sample_sink = None
        if not sending:
            if self.raw_mode:
                n = settings.get_receive_buffer_size(
                    self.resume_on_full_receive_buffer, self.is_in_spectrum_mode)
                self.receive_buffer = IQData(None, dtype=self.DATA_TYPE, n=n)
            else:
                self.received_bits = []

    # -- state ------------------------------------------------------------
    @property
    def is_sending(self) -> bool:
        return self._is_sending

    @is_sending.setter
    def is_sending(self, value: bool):
        if value != self._is_sending:
            self._is_sending = value
            self.sending_status_changed.emit(value)

    @property
    def sending_finished(self) -> bool:
        return self.current_sending_repeat >= self.sending_repeats

    @property
    def received_data(self):
        if self.raw_mode:
            return self.receive_buffer[:self.current_receive_index]
        return self.received_bits

    @property
    def current_receive_index(self) -> int:
        return self._sample_sink.write_index if self._sample_sink else 0

    @current_receive_index.setter
    def current_receive_index(self, value: int):
        if self._sample_sink:
            self._sample_sink.write_index = value

    def take_receive_index(self) -> tuple:
        """-> (current_receive_index, when the first write since the
        previous call committed (``metrics.now_ns()``), or None)."""
        return self._sample_sink.take() if self._sample_sink else (0, None)

    def free_data(self):
        if self.raw_mode:
            self.current_receive_index = 0
        else:
            self.received_bits[:] = []

    # -- receiving --------------------------------------------------------
    def start_tcp_server_for_receiving(self):
        server = socketserver.TCPServer((self.server_ip, self.server_port),
                                        _ReceiveHandler, bind_and_activate=False)
        server.allow_reuse_address = True
        server.server_bind()
        server.server_activate()
        self.server_port = server.server_address[1]

        if self.raw_mode:
            self._sample_sink = SampleSink(self.receive_buffer)
            server.make_decoder = lambda: IQStreamDecoder(self.DATA_TYPE)
            server.sink = self._sample_sink
        else:
            server.make_decoder = BitLineDecoder
            server.sink = self.received_bits.extend

        self.server = server
        self.server_thread = threading.Thread(target=server.serve_forever,
                                              daemon=True)
        self.server_thread.start()
        self.receive_server_started.emit()

    def stop_tcp_server(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()

    # -- sending ----------------------------------------------------------
    def _open_send_socket(self):
        try:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.connect((self.client_ip, self.client_port))
            return sock
        except Exception as e:
            self.error_occurred.emit("could not establish connection " + str(e))
            return None

    def _run_transmission(self, steps) -> bool:
        """Shared driver: open socket, push (payload, sleep_after) steps
        until done or interrupted."""
        sock = self._open_send_socket()
        if sock is None:
            return False
        try:
            for payload, sleep_after in steps:
                if self._interrupt:
                    return False
                if payload:
                    sock.sendall(payload)
                if sleep_after:
                    time.sleep(sleep_after)
            return True
        except OSError as e:
            self.error_occurred.emit(str(e))
            return False
        finally:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()

    def _repeat_range(self, num_repeats: int):
        return iter(int, 1) if num_repeats <= 0 else range(num_repeats)

    def _raw_steps(self, data, num_repeats: int):
        payload = (data.to_bytes() if isinstance(data, IQData)
                   else np.asarray(data).tobytes())
        for _ in self._repeat_range(num_repeats):
            if self._interrupt:
                return
            yield payload, 0
            self.current_sent_sample = len(data)
            self.current_sending_repeat += 1

    def _continuous_steps(self, ring_buffer: RingBuffer, total: int,
                          num_repeats: int):
        """Drain the shared-memory ring as it fills (the modulator process
        writes into it concurrently)."""
        per_pop = RECV_CHUNK // 2
        for _ in self._repeat_range(num_repeats):
            while total is None or self.current_sent_sample < total:
                while ring_buffer.is_empty and not self._interrupt:
                    time.sleep(0.1)
                if self._interrupt:
                    return
                want = per_pop if total is None else max(
                    0, min(per_pop, total - self.current_sent_sample))
                # the final (possibly odd) tail of a finite send must be
                # allowed through, else a 1-sample remainder spins forever
                chunk = ring_buffer.pop(
                    want, ensure_even_length=(want == per_pop))
                if len(chunk):
                    self.current_sent_sample += len(chunk)
                    yield chunk.tobytes(), 0
            self.current_sending_repeat += 1
            self.current_sent_sample = 0
        self.current_sent_sample = total

    def _message_steps(self, messages, sample_rates):
        for i, msg in enumerate(messages):
            self.current_send_message_changed.emit(i)
            yield (bytes_from_bits(msg.encoded_bits_str) + b"\n",
                   msg.pause / sample_rates[i])

    def send_raw_data(self, data, num_repeats: int):
        self._run_transmission(self._raw_steps(data, num_repeats))

    def send_raw_data_continuously(self, ring_buffer, num_samples_to_send,
                                   num_repeats):
        self._run_transmission(self._continuous_steps(
            ring_buffer, num_samples_to_send, num_repeats))

    def _send_messages(self, messages, sample_rates):
        self.is_sending = True
        try:
            self._run_transmission(self._message_steps(messages, sample_rates))
        finally:
            self.is_sending = False

    def _start_send_thread(self, target, *args):
        self._interrupt = False
        self.sending_thread = threading.Thread(target=target, args=args,
                                               daemon=True)
        self.sending_thread.start()
        self.send_connection_established.emit()

    def start_message_sending_thread(self, messages, sample_rates):
        self._start_send_thread(self._send_messages, messages, sample_rates)

    def start_raw_sending_thread(self):
        if self.sending_is_continuous:
            self._start_send_thread(self.send_raw_data_continuously,
                                    self.continuous_send_ring_buffer,
                                    self.num_samples_to_send,
                                    self.sending_repeats)
        else:
            self._start_send_thread(self.send_raw_data, self.samples_to_send,
                                    self.sending_repeats)

    def stop_sending_thread(self):
        self._interrupt = True
        if hasattr(self, "sending_thread"):
            self.sending_thread.join()
        self.sending_stop_requested.emit()

    # kept as the public helper names used elsewhere in the framework
    bytearray_to_bit_str = staticmethod(bits_from_bytes)
    bit_str_to_bytearray = staticmethod(bytes_from_bits)
