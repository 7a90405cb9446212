"""VirtualDevice: uniform facade over device backends.

Counterpart of urh/dev/VirtualDevice.py (908 LoC): one API
(start/stop/data/...) over the native process-runtime backend and the
Network SDR TCP backend, with lifecycle events replacing Qt signals.
"""

from __future__ import annotations

import time
from enum import Enum

import numpy as np

from urh_tpu_torch.dev import config
from urh_tpu_torch.dev.backend_handler import BackendHandler, Backends
from urh_tpu_torch.dev.network_sdr import NetworkSDRInterfacePlugin
from urh_tpu_torch.util.events import Event
from urh_tpu_torch.util.logging import logger


class Mode(Enum):
    receive = 1
    send = 2
    spectrum = 3


class VirtualDevice:
    continuous_send_msg = "Continuous send mode is not supported for this backend."

    def __init__(self, backend_handler, name: str, mode: Mode, freq=None,
                 sample_rate=None, bandwidth=None, gain=None, if_gain=None,
                 baseband_gain=None, samples_to_send=None, device_ip=None,
                 sending_repeats=1, parent=None, resume_on_full_receive_buffer=False,
                 raw_mode=True, portnumber=1234):
        self.name = name
        self.mode = mode
        self.backend_handler = backend_handler if backend_handler is not None else BackendHandler()
        self._data_timestamp = 0

        self.started = Event()
        self.stopped = Event()
        self.sender_needs_restart = Event()
        self.fatal_error_occurred = Event(str)
        self.ready_for_action = Event()

        freq = config.DEFAULT_FREQUENCY if freq is None else freq
        sample_rate = config.DEFAULT_SAMPLE_RATE if sample_rate is None else sample_rate
        bandwidth = config.DEFAULT_BANDWIDTH if bandwidth is None else bandwidth
        gain = config.DEFAULT_GAIN if gain is None else gain
        if_gain = config.DEFAULT_IF_GAIN if if_gain is None else if_gain
        baseband_gain = config.DEFAULT_BB_GAIN if baseband_gain is None else baseband_gain

        resume_on_full_receive_buffer = (mode == Mode.spectrum or resume_on_full_receive_buffer)

        if self.name == NetworkSDRInterfacePlugin.NETWORK_SDR_NAME:
            self.backend = Backends.network
        else:
            try:
                self.backend = self.backend_handler.device_backends[name.lower()].selected_backend
            except KeyError:
                logger.warning("invalid device name: {0}".format(name))
                self.backend = Backends.none
                self._dev = None
                return

        if self.backend == Backends.native:
            self._dev = self._create_native_device(
                name.lower(), freq, sample_rate, bandwidth, gain, if_gain,
                baseband_gain, resume_on_full_receive_buffer, device_ip, portnumber)
            self._dev.device_ip = device_ip if device_ip else self._dev.device_ip
            if mode == Mode.send:
                self._dev.init_send_parameters(samples_to_send, sending_repeats)
        elif self.backend == Backends.network:
            self._dev = NetworkSDRInterfacePlugin(raw_mode=raw_mode,
                                                  resume_on_full_receive_buffer=resume_on_full_receive_buffer,
                                                  spectrum=(mode == Mode.spectrum),
                                                  sending=(mode == Mode.send))
            self._dev.send_connection_established.connect(self.emit_ready_for_action)
            self._dev.receive_server_started.connect(self.emit_ready_for_action)
            self._dev.error_occurred.connect(self.emit_fatal_error_occurred)
            self._dev.samples_to_send = samples_to_send
            self._dev.sending_repeats = sending_repeats
        elif self.backend == Backends.none:
            self._dev = None
        else:
            raise ValueError("unsupported backend " + str(self.backend))

    @staticmethod
    def _create_native_device(name, freq, sample_rate, bandwidth, gain, if_gain,
                              baseband_gain, resume_on_full_receive_buffer,
                              device_ip, portnumber):
        from urh_tpu_torch.dev import native_devices as nd

        if name.replace("-", "") == "rtltcp":
            from urh_tpu_torch.dev.rtl_tcp import RTLSDRTCP

            return RTLSDRTCP(freq, gain, sample_rate, bandwidth, device_number=0,
                             resume_on_full_receive_buffer=resume_on_full_receive_buffer)
        if name == "hackrf":
            return nd.HackRF(freq, sample_rate, bandwidth, gain, if_gain, baseband_gain,
                             resume_on_full_receive_buffer)
        if name == "rad1o":
            return nd.Rad1o(freq, sample_rate, bandwidth, gain, if_gain, baseband_gain,
                            resume_on_full_receive_buffer)
        if name.replace("-", "") == "rtlsdr":
            return nd.RTLSDR(freq, gain, sample_rate, device_number=0,
                             resume_on_full_receive_buffer=resume_on_full_receive_buffer)
        scaffolds = {"usrp": nd.USRP, "limesdr": nd.LimeSDR, "bladerf": nd.BladeRF,
                     "plutosdr": nd.PlutoSDR, "sdrplay": nd.SDRPlay,
                     "airspy r2": nd.AirSpy, "airspy mini": nd.AirSpy,
                     "soundcard": nd.SoundCard}
        if name in scaffolds:
            return scaffolds[name](freq, sample_rate, bandwidth, gain, if_gain,
                                   baseband_gain, resume_on_full_receive_buffer)
        raise ValueError(
            f"native backend for {name} requires its vendor library binding")

    # -- properties --------------------------------------------------------
    @property
    def data_type(self):
        if self.backend == Backends.network:
            return NetworkSDRInterfacePlugin.DATA_TYPE
        if self._dev is not None:
            return self._dev.DATA_TYPE
        return np.float32

    @property
    def has_multi_device_support(self):
        return self.backend == Backends.native and self._dev.has_multi_device_support

    # -- table-generated forwarders ---------------------------------------
    def _native_param(attr, default=0):
        """Property forwarding to the native device; other backends read
        ``default`` and ignore writes."""
        def get(self):
            return (getattr(self._dev, attr)
                    if self.backend == Backends.native else default)

        def set(self, value):
            if self.backend == Backends.native:
                setattr(self._dev, attr, value)

        return property(get, set)

    def _send_param(attr):
        """Property forwarding for TX state shared by native + network
        backends; anything else raises the continuous-send error."""
        def get(self):
            if self.backend in (Backends.native, Backends.network):
                return getattr(self._dev, attr)
            raise ValueError(self.continuous_send_msg)

        def set(self, value):
            if self.backend in (Backends.native, Backends.network):
                setattr(self._dev, attr, value)
            else:
                raise ValueError(self.continuous_send_msg)

        return property(get, set)

    bandwidth = _native_param("bandwidth")
    gain = _native_param("gain")
    if_gain = _native_param("if_gain")
    baseband_gain = _native_param("baseband_gain")
    device_serial = _native_param("device_serial", default=None)
    device_number = _native_param("device_number")

    num_samples_to_send = _send_param("num_samples_to_send")
    is_send_continuous = _send_param("sending_is_continuous")

    del _native_param, _send_param

    @property
    def bandwidth_is_adjustable(self):
        return (self._dev.bandwidth_is_adjustable
                if self.backend == Backends.native else True)

    @property
    def frequency(self):
        if self.backend == Backends.native:
            return self._dev.frequency
        raise ValueError("unsupported backend")

    @frequency.setter
    def frequency(self, value):
        if self.backend == Backends.native:
            self._dev.frequency = value
        elif self.backend != Backends.network:  # network: no tuning, no error
            raise ValueError("unsupported backend")

    @property
    def sample_rate(self):
        return (self._dev.sample_rate if self.backend == Backends.native
                else config.DEFAULT_SAMPLE_RATE)

    @sample_rate.setter
    def sample_rate(self, value):
        if self.backend == Backends.native:
            self._dev.sample_rate = value

    @property
    def samples_to_send(self):
        if self.backend in (Backends.native, Backends.network):
            return self._dev.samples_to_send
        raise ValueError("unsupported backend")

    @samples_to_send.setter
    def samples_to_send(self, value):
        if self.backend == Backends.native:
            self._dev.init_send_parameters(value)
        elif self.backend == Backends.network:
            self._dev.samples_to_send = value
        else:
            raise ValueError("unsupported backend")

    @property
    def is_raw_mode(self) -> bool:
        return self._dev.raw_mode if self.backend == Backends.network else True

    @property
    def continuous_send_ring_buffer(self):
        if self.backend in (Backends.native, Backends.network):
            return self._dev.continuous_send_ring_buffer
        raise ValueError(self.continuous_send_msg)

    @continuous_send_ring_buffer.setter
    def continuous_send_ring_buffer(self, value):
        if self.backend in (Backends.native, Backends.network):
            self._dev.continuous_send_ring_buffer = value
        else:
            raise ValueError(self.continuous_send_msg)

    @property
    def is_in_spectrum_mode(self):
        return self.mode == Mode.spectrum

    @property
    def resume_on_full_receive_buffer(self) -> bool:
        return self._dev.resume_on_full_receive_buffer

    @resume_on_full_receive_buffer.setter
    def resume_on_full_receive_buffer(self, value: bool):
        if value != self._dev.resume_on_full_receive_buffer:
            self._dev.resume_on_full_receive_buffer = value
            if self.backend == Backends.native:
                self._dev.receive_buffer = None

    @property
    def num_sending_repeats(self):
        return self._dev.sending_repeats

    @num_sending_repeats.setter
    def num_sending_repeats(self, value):
        self._dev.sending_repeats = value

    @property
    def current_index(self):
        if self.backend == Backends.native:
            return (self._dev.current_sent_sample if self.mode == Mode.send
                    else self._dev.current_recv_index)
        if self.backend == Backends.network:
            return (self._dev.current_sent_sample if self.mode == Mode.send
                    else self._dev.current_receive_index)
        raise ValueError("unsupported backend")

    @current_index.setter
    def current_index(self, value):
        if self.backend == Backends.native:
            if self.mode == Mode.send:
                self._dev.current_sent_sample = value
            else:
                self._dev.current_recv_index = value
        elif self.backend == Backends.network:
            if self.mode == Mode.send:
                self._dev.current_sent_sample = value
            else:
                self._dev.current_receive_index = value
        else:
            raise ValueError("unsupported backend")

    def take_receive_index(self) -> tuple:
        """-> (current_index, when the first write since the previous call
        committed, on ``util.metrics.now_ns()``'s clock, or None where the
        backend does not stamp its writes: all but the Network SDR's)."""
        if self.backend == Backends.network and self.mode == Mode.receive:
            return self._dev.take_receive_index()
        return self.current_index, None

    @property
    def data(self):
        if self.backend == Backends.native:
            return self._dev.samples_to_send if self.mode == Mode.send else self._dev.receive_buffer
        if self.backend == Backends.network:
            if self.mode == Mode.send:
                return self._dev.samples_to_send
            if self._dev.raw_mode:
                return self._dev.receive_buffer
            return self._dev.received_bits
        raise ValueError("unsupported backend")

    @data.setter
    def data(self, value):
        if self.backend == Backends.native:
            if self.mode == Mode.send:
                self._dev.samples_to_send = value
            else:
                self._dev.receive_buffer = value

    def free_data(self):
        if self.backend == Backends.native:
            self._dev.samples_to_send = np.array([], dtype=self._dev.DATA_TYPE)
            self._dev.receive_buffer = None
        elif self.backend == Backends.network:
            self._dev.free_data()

    @property
    def sending_finished(self):
        if self.backend in (Backends.native, Backends.network):
            return self._dev.sending_finished
        raise ValueError("unsupported backend")

    @property
    def spectrum(self):
        if self.mode != Mode.spectrum:
            raise ValueError("spectrum only available in spectrum mode")
        buffer = self._dev.receive_buffer
        w = np.abs(np.fft.fft(buffer.as_complex64()))
        freqs = np.fft.fftfreq(len(w), 1 / self.sample_rate)
        idx = np.argsort(freqs)
        return freqs[idx].astype(np.float32), w[idx].astype(np.float32)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._data_timestamp = time.time()
        if self.backend == Backends.native:
            if self.mode == Mode.send:
                self._dev.start_tx_mode(resume=True)
            else:
                self._dev.start_rx_mode()
            self.emit_started_signal()
        elif self.backend == Backends.network:
            if self.mode in (Mode.receive, Mode.spectrum):
                self._dev.start_tcp_server_for_receiving()
            else:
                self._dev.start_raw_sending_thread()
            self.emit_started_signal()
        else:
            raise ValueError("unsupported backend")

    def stop(self, msg: str):
        if self.backend == Backends.native:
            if self.mode == Mode.send:
                self._dev.stop_tx_mode(msg)
            else:
                self._dev.stop_rx_mode(msg)
            self.emit_stopped_signal()
        elif self.backend == Backends.network:
            self._dev.stop_tcp_server()
            self._dev.stop_sending_thread()
            self.emit_stopped_signal()
        elif self.backend == Backends.none:
            pass
        else:
            logger.error("stop device: unsupported backend " + str(self.backend))

    def stop_on_error(self, msg: str):
        if self.backend == Backends.native:
            self.read_messages()
            self._dev.stop_rx_mode("Stop on error")
            self._dev.stop_tx_mode("Stop on error")
            self.emit_stopped_signal()

    def cleanup(self):
        if self.backend == Backends.native:
            self.data = None

    def emit_stopped_signal(self):
        self.stopped.emit()

    def emit_started_signal(self):
        self.started.emit()

    def emit_sender_needs_restart(self):
        self.sender_needs_restart.emit()

    def emit_ready_for_action(self):
        self.ready_for_action.emit()

    def emit_fatal_error_occurred(self, msg: str):
        self.fatal_error_occurred.emit(msg)

    def read_messages(self) -> str:
        if self.backend == Backends.native:
            messages = "\n".join(self._dev.device_messages)
            self._dev.device_messages.clear()
            if messages and not messages.endswith("\n"):
                messages += "\n"
            if "successfully started" in messages:
                self.ready_for_action.emit()
            elif "failed to start" in messages:
                self.fatal_error_occurred.emit(messages[messages.index("failed to start") :])
            return messages
        if self.backend == Backends.network:
            return ""
        raise ValueError("unsupported backend")

    def set_server_port(self, port: int):
        if self.backend == Backends.network:
            self._dev.server_port = port
        else:
            raise ValueError("setting port only supported for NetworkSDR")

    def set_client_port(self, port: int):
        if self.backend == Backends.network:
            self._dev.client_port = port
        else:
            raise ValueError("setting port only supported for NetworkSDR")

    @property
    def underlying_device(self):
        return self._dev

    def get_device_list(self):
        if hasattr(self._dev, "get_device_list"):
            return self._dev.get_device_list()
        return []
