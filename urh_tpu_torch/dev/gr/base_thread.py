"""GNU Radio backend: external flowgraph process + TCP sample transport.

Counterpart of urh/dev/gr/AbstractBaseThread.py (without Qt): spawns a
configured external Python interpreter running a per-device osmosdr
flowgraph script; parameters travel via argv and stdin command lines
("F:<freq>", "SR:<rate>", ...); samples stream over a localhost TCP
socket.  Requires a GNU Radio installation in the configured
interpreter — probed, never assumed.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time
from queue import Empty, Queue
from subprocess import PIPE, Popen

from urh_tpu_torch.util import settings
from urh_tpu_torch.util.events import Event
from urh_tpu_torch.util.logging import logger

SCRIPTS_DIR = os.path.join(os.path.dirname(__file__), "scripts")


class AbstractBaseThread(threading.Thread):
    def __init__(self, frequency, sample_rate, bandwidth, gain, if_gain,
                 baseband_gain, receiving: bool, ip="127.0.0.1"):
        super().__init__(daemon=True)
        self.ip = ip
        self.gr_port = 1337
        self._sample_rate = sample_rate
        self._frequency = frequency
        self._gain = gain
        self._if_gain = if_gain
        self._baseband_gain = baseband_gain
        self._bandwidth = bandwidth
        self._freq_correction = 1
        self._direct_sampling_mode = 0
        self._antenna_index = 0
        self._channel_index = 0
        self._receiving = receiving
        self.device = "USRP"
        self.current_index = 0
        self.is_in_spectrum_mode = False
        self.socket = None

        self.started_event = Event()
        self.stopped_event = Event()
        self.sender_needs_restart = Event()

        self.gr_python_interpreter = settings.read("gr_python_interpreter", "", str)

        self.queue = Queue()
        self.data = None
        self.current_iteration = 0
        self.gr_process = None
        self._stop_requested = False

    def _make_param(name, command):
        private = "_" + name

        def get(self):
            return getattr(self, private)

        def set(self, value):
            setattr(self, private, value)
            if self.gr_process:
                try:
                    self.gr_process.stdin.write(
                        command.encode() + b":" + str(value).encode() + b"\n")
                    self.gr_process.stdin.flush()
                except BrokenPipeError:
                    pass

        return property(get, set)

    sample_rate = _make_param("sample_rate", "SR")
    frequency = _make_param("frequency", "F")
    gain = _make_param("gain", "G")
    if_gain = _make_param("if_gain", "IFG")
    baseband_gain = _make_param("baseband_gain", "BBG")
    bandwidth = _make_param("bandwidth", "BW")
    freq_correction = _make_param("freq_correction", "FC")
    direct_sampling_mode = _make_param("direct_sampling_mode", "DSM")
    antenna_index = _make_param("antenna_index", "ANT")
    channel_index = _make_param("channel_index", "CHAN")

    del _make_param

    @property
    def device_script_name(self) -> str:
        direction = "recv" if self._receiving else "send"
        return "{}_{}.py".format(self.device.lower().replace(" ", "").replace("-", ""), direction)

    def init_process(self):
        if not self.gr_python_interpreter:
            raise RuntimeError(
                "no GNU Radio python interpreter configured "
                "(set 'gr_python_interpreter' in settings)")

        script = os.path.join(SCRIPTS_DIR, self.device_script_name)
        if not os.path.isfile(script):
            raise RuntimeError("no GNU Radio script for device " + self.device)

        options = [self.gr_python_interpreter, script,
                   "--samplerate", str(int(self.sample_rate)),
                   "--freq", str(int(self.frequency)),
                   "--gain", str(int(self.gain)),
                   "--port", str(self.gr_port)]
        if self._bandwidth:
            options.extend(["--bandwidth", str(int(self._bandwidth))])
        if self._if_gain:
            options.extend(["--if-gain", str(int(self._if_gain))])
        if self._baseband_gain:
            options.extend(["--bb-gain", str(int(self._baseband_gain))])

        logger.info("starting GNU Radio process: " + " ".join(options))
        self.gr_process = Popen(options, stdin=PIPE, stderr=PIPE, stdout=PIPE)

    def run(self):
        raise NotImplementedError

    def stop(self, msg: str):
        self._stop_requested = True
        if msg:
            logger.info(msg)
        if self.gr_process:
            try:
                self.gr_process.kill()
            except OSError:
                pass
            self.gr_process = None
        if self.socket is not None:
            try:
                self.socket.close()
            except OSError:
                pass
        self.stopped_event.emit()

    def read_errors(self) -> str:
        if self.gr_process is None or self.gr_process.stderr is None:
            return ""
        import select

        result = []
        while True:
            ready, _, _ = select.select([self.gr_process.stderr], [], [], 0)
            if not ready:
                break
            line = self.gr_process.stderr.readline()
            if not line:
                break
            result.append(line.decode(errors="replace"))
        return "".join(result)


class ReceiverThread(AbstractBaseThread):
    """Connects to the flowgraph's TCP sink and drains samples into the
    receive buffer (urh/dev/gr/ReceiverThread.py counterpart)."""

    def __init__(self, frequency, sample_rate, bandwidth, gain, if_gain,
                 baseband_gain, ip="127.0.0.1", parent=None,
                 resume_on_full_receive_buffer=False):
        super().__init__(frequency, sample_rate, bandwidth, gain, if_gain,
                         baseband_gain, receiving=True, ip=ip)
        self.resume_on_full_receive_buffer = resume_on_full_receive_buffer
        self.data = None

    def init_recv_buffer(self):
        import numpy as np

        from urh_tpu_torch.core.iq import IQData

        n = settings.get_receive_buffer_size(self.resume_on_full_receive_buffer,
                                             self.is_in_spectrum_mode)
        self.data = IQData(None, np.float32, n)

    def run(self):
        import numpy as np

        if self.data is None:
            self.init_recv_buffer()

        self.init_process()
        self.started_event.emit()

        # wait for the flowgraph's TCP server
        for _ in range(50):
            try:
                self.socket = socket.create_connection((self.ip, self.gr_port), timeout=1)
                break
            except OSError:
                time.sleep(0.1)
        else:
            self.stop("could not connect to GNU Radio flowgraph")
            return

        while not self._stop_requested:
            try:
                chunk = self.socket.recv(65536)
            except OSError:
                break
            if not chunk:
                break
            samples = np.frombuffer(chunk[: len(chunk) - len(chunk) % 8],
                                    dtype=np.float32).reshape(-1, 2)
            n = len(samples)
            if self.current_index + n >= len(self.data):
                if self.resume_on_full_receive_buffer:
                    self.current_index = 0
                else:
                    break
            self.data[self.current_index : self.current_index + n] = samples
            self.current_index += n

        self.stop("receiver finished")


class SenderThread(AbstractBaseThread):
    """Streams samples to the flowgraph's TCP source
    (urh/dev/gr/SenderThread.py counterpart)."""

    def __init__(self, frequency, sample_rate, bandwidth, gain, if_gain,
                 baseband_gain, ip="127.0.0.1", parent=None):
        super().__init__(frequency, sample_rate, bandwidth, gain, if_gain,
                         baseband_gain, receiving=False, ip=ip)
        self.data = None
        self.samples_per_transmission = 2 ** 15

    def run(self):
        import numpy as np

        self.init_process()
        self.started_event.emit()

        server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server.bind((self.ip, self.gr_port))
        server.listen(1)
        server.settimeout(5)
        try:
            conn, _ = server.accept()
        except socket.timeout:
            self.stop("GNU Radio flowgraph did not connect")
            return

        data = np.asarray(self.data, dtype=np.float32)
        pos = 0
        while not self._stop_requested and pos < len(data):
            chunk = data[pos : pos + self.samples_per_transmission]
            try:
                conn.sendall(chunk.tobytes())
            except OSError:
                break
            pos += len(chunk)
            self.current_index = pos

        conn.close()
        server.close()
        self.stop("sender finished")


class SpectrumThread(ReceiverThread):
    """Receiver variant keeping a rolling FFT of the last window
    (urh/dev/gr/SpectrumThread.py counterpart)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("resume_on_full_receive_buffer", True)
        super().__init__(*args, **kwargs)
        self.x = None
        self.y = None

    def update_spectrum(self):
        import numpy as np

        data = self.data.as_complex64()[: self.current_index]
        if len(data) == 0:
            return
        w = np.abs(np.fft.fft(data[-settings.SPECTRUM_BUFFER_SIZE :]))
        freqs = np.fft.fftfreq(len(w), 1 / self.sample_rate)
        idx = np.argsort(freqs)
        self.x = freqs[idx].astype(np.float32)
        self.y = w[idx].astype(np.float32)
