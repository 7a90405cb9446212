"""Native device runtime: process-per-device RX/TX with pipe IPC.

Counterpart of urh/dev/native/Device.py (874 LoC): every RX/TX runs in
a spawned multiprocessing.Process connected to the parent by a data
pipe (raw sample bytes) and a duplex control pipe carrying
(Command, value) tuples and string acknowledgements.  A parent reader
thread drains the data pipe into the receive buffer; TX streams from a
shared send buffer or a shared-memory ring buffer (continuous mode).

Concrete SDRs subclass this with their library binding; the TCP-based
NetworkSDR (urh_tpu_torch/dev/network_sdr.py) is the hardware-free
backend.  The children never touch CUDA: they pass sample bytes, and the
parent's sniffer or sender moves them to the card.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from enum import Enum
import multiprocessing

# fork would copy a parent's CUDA context and threads; always spawn children
_mp = multiprocessing.get_context("spawn")

import numpy as np

from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.util import settings
from urh_tpu_torch.util.logging import logger


@dataclass
class SendConfig:
    """Shared-state TX cursor handed into the device child process
    (urh/dev/native/SendConfig.py)."""

    send_buffer: object
    current_sent_index: object
    current_sending_repeat: object
    total_samples: int
    sending_repeats: int
    continuous: bool = False
    iq_to_bytes_method: object = None
    continuous_send_ring_buffer: object = None

    @property
    def _scalar_dtype(self):
        return self.send_buffer._type_._type_

    def _idle_chunk(self):
        return np.zeros(1, dtype=self._scalar_dtype)

    def _next_chunk(self, buffer_length: int):
        if self.continuous:
            return self.iq_to_bytes_method(
                self.continuous_send_ring_buffer.pop(buffer_length // 2))
        cursor = self.current_sent_index.value
        view = np.frombuffer(self.send_buffer, dtype=self._scalar_dtype)
        return view[cursor:cursor + buffer_length]

    def get_data_to_send(self, buffer_length: int):
        try:
            if self.sending_is_finished():
                return self._idle_chunk()
            chunk = self._next_chunk(buffer_length)
            if len(chunk) == 0:
                return self._idle_chunk()
            self.progress_send_status(len(chunk))
            return chunk
        except (BrokenPipeError, EOFError):
            return self._idle_chunk()

    def sending_is_finished(self):
        if self.sending_repeats == 0:  # 0 = forever
            return False
        return (self.current_sending_repeat.value >= self.sending_repeats
                and self.current_sent_index.value >= self.total_samples)

    def progress_send_status(self, sent: int):
        cursor = self.current_sent_index.value + sent
        if cursor >= self.total_samples - 1:
            self.current_sending_repeat.value += 1
            more = (self.current_sending_repeat.value < self.sending_repeats
                    or self.sending_repeats == 0)
            cursor = 0 if more else self.total_samples
        self.current_sent_index.value = cursor


class Device:
    # how long a stop waits for its child before terminating it; urh_tpu
    # waits 1 s, which cut short a child that had imported torch and was
    # stopping cleanly
    JOIN_TIMEOUT = 10.0

    SYNC_TX_CHUNK_SIZE = 0
    CONTINUOUS_TX_CHUNK_SIZE = 0

    DATA_TYPE = np.float32
    ASYNCHRONOUS = False
    DEVICE_LIB = None

    # control-plane vocabulary; the wire format is the NAME string so the
    # members can be generated from one list (values are just ordinals)
    Command = Enum("Command", [
        "STOP", "SET_FREQUENCY", "SET_SAMPLE_RATE", "SET_BANDWIDTH",
        "SET_RF_GAIN", "SET_IF_GAIN", "SET_BB_GAIN",
        "SET_DIRECT_SAMPLING_MODE", "SET_FREQUENCY_CORRECTION",
        "SET_CHANNEL_INDEX", "SET_ANTENNA_INDEX", "SET_BIAS_TEE_ENABLED",
    ], start=0)

    DEVICE_METHODS = {
        "SET_FREQUENCY": "set_center_freq",
        "SET_SAMPLE_RATE": "set_sample_rate",
        "SET_BANDWIDTH": "set_bandwidth",
        "SET_RF_GAIN": "set_rf_gain",
        "SET_IF_GAIN": {"rx": "set_if_rx_gain", "tx": "set_if_tx_gain"},
        "SET_BB_GAIN": {"rx": "set_baseband_gain"},
    }

    @classmethod
    def get_device_list(cls):
        return []

    # -- child-process side -----------------------------------------------
    # One generic child loop serves both roles; everything role-specific
    # lives in this table: (async idle sleep, post-loop hardware drain).
    _ROLE = {
        "rx": {"idle_sleep": 0.25, "drain": 0.0},
        "tx": {"idle_sleep": 0.5, "drain": 0.75},
    }

    @classmethod
    def _resolve_lib_method(cls, tag: str, role: str):
        spec = cls.DEVICE_METHODS.get(tag)
        return spec.get(role) if isinstance(spec, dict) else spec

    @classmethod
    def process_command(cls, command, ctrl_connection, is_tx: bool):
        """Table dispatch: (tag, value) -> DEVICE_LIB method, ack over the
        ctrl pipe as 'TAG to VALUE:retcode'."""
        if command == cls.Command.STOP.name:
            return cls.Command.STOP.name

        tag, value = command
        method_name = cls._resolve_lib_method(tag, "tx" if is_tx else "rx")
        if not method_name:
            return None
        try:
            ret = getattr(cls.DEVICE_LIB, method_name)(value)
        except AttributeError as e:
            logger.warning(str(e))
            return None
        ctrl_connection.send("{0} to {1}:{2}".format(tag, value, ret))

    @classmethod
    def setup_device(cls, ctrl_connection, device_identifier):
        raise NotImplementedError("overwrite in subclass")

    @classmethod
    def shutdown_device(cls, ctrl_connection, is_tx: bool):
        pass

    @classmethod
    def init_device(cls, ctrl_connection, is_tx: bool, parameters: OrderedDict) -> bool:
        if not cls.setup_device(ctrl_connection,
                                device_identifier=parameters["identifier"]):
            return False
        role = "tx" if is_tx else "rx"
        for tag, value in parameters.items():
            if cls._resolve_lib_method(tag, role):
                cls.process_command((tag, value), ctrl_connection, is_tx)
        return True

    @classmethod
    def adapt_num_read_samples_to_sample_rate(cls, sample_rate):
        raise NotImplementedError

    @classmethod
    def enter_async_receive_mode(cls, data_connection, ctrl_connection):
        raise NotImplementedError

    @classmethod
    def prepare_sync_receive(cls, ctrl_connection):
        raise NotImplementedError

    @classmethod
    def receive_sync(cls, data_conn):
        raise NotImplementedError

    @classmethod
    def enter_async_send_mode(cls, callback):
        raise NotImplementedError

    @classmethod
    def prepare_sync_send(cls, ctrl_connection):
        raise NotImplementedError

    @classmethod
    def send_sync(cls, data):
        raise NotImplementedError

    @classmethod
    def _drain_commands(cls, ctrl_connection, is_tx: bool) -> bool:
        """Handle every queued control command; True when STOP arrived or
        the pipe died."""
        while ctrl_connection.poll():
            try:
                result = cls.process_command(ctrl_connection.recv(),
                                             ctrl_connection, is_tx)
            except (EOFError, BrokenPipeError, ConnectionResetError):
                return True
            if result == cls.Command.STOP.name:
                return True
        return False

    @classmethod
    def _child_main(cls, role: str, ctrl_connection, dev_parameters,
                    enter_async, prepare_sync, step, done):
        """Shared skeleton of the device child process: init -> stream
        until STOP/finished -> shutdown."""
        is_tx = role == "tx"
        if not cls.init_device(ctrl_connection, is_tx, dev_parameters):
            ctrl_connection.send(f"failed to start {role} mode")
            return False

        ret = enter_async() if cls.ASYNCHRONOUS else prepare_sync()
        if ret != 0:
            ctrl_connection.send(f"failed to start {role} mode")
            return False
        ctrl_connection.send(f"successfully started {role} mode")

        spec = cls._ROLE[role]
        while not done():
            if cls.ASYNCHRONOUS:
                try:
                    time.sleep(spec["idle_sleep"])
                except KeyboardInterrupt:
                    pass
            else:
                step()
            if cls._drain_commands(ctrl_connection, is_tx):
                break

        if not cls.ASYNCHRONOUS and spec["drain"]:
            # some sync send paths are non-blocking: drain the HW buffer
            time.sleep(spec["drain"])
        cls.shutdown_device(ctrl_connection, is_tx)

    @classmethod
    def device_receive(cls, data_connection, ctrl_connection, dev_parameters):
        try:
            cls.adapt_num_read_samples_to_sample_rate(
                dev_parameters[cls.Command.SET_SAMPLE_RATE.name])
        except NotImplementedError:
            pass
        cls._child_main(
            "rx", ctrl_connection, dev_parameters,
            enter_async=lambda: cls.enter_async_receive_mode(data_connection,
                                                             ctrl_connection),
            prepare_sync=lambda: cls.prepare_sync_receive(ctrl_connection),
            step=lambda: cls.receive_sync(data_connection),
            done=lambda: False)
        data_connection.close()
        ctrl_connection.close()

    @classmethod
    def device_send(cls, ctrl_connection, send_config: SendConfig, dev_parameters):
        chunk = (cls.CONTINUOUS_TX_CHUNK_SIZE if send_config.continuous
                 else cls.SYNC_TX_CHUNK_SIZE)
        cls._child_main(
            "tx", ctrl_connection, dev_parameters,
            enter_async=lambda: cls.enter_async_send_mode(
                send_config.get_data_to_send),
            prepare_sync=lambda: cls.prepare_sync_send(ctrl_connection),
            step=lambda: cls.send_sync(send_config.get_data_to_send(chunk)),
            done=send_config.sending_is_finished)
        ctrl_connection.close()

    # -- parent-process side ----------------------------------------------
    # attribute -> forwarded control command; one table drives the
    # generated properties AND device_parameters (single source of truth)
    FORWARDED_PARAMS = {
        "frequency": "SET_FREQUENCY",
        "sample_rate": "SET_SAMPLE_RATE",
        "gain": "SET_RF_GAIN",
        "if_gain": "SET_IF_GAIN",
        "baseband_gain": "SET_BB_GAIN",
        "freq_correction": "SET_FREQUENCY_CORRECTION",
        "direct_sampling_mode": "SET_DIRECT_SAMPLING_MODE",
        "channel_index": "SET_CHANNEL_INDEX",
        "antenna_index": "SET_ANTENNA_INDEX",
        "bias_tee_enabled": "SET_BIAS_TEE_ENABLED",
    }

    # defaults for every parent-side field that is not a constructor
    # argument; __init__ applies this table wholesale
    _PARENT_STATE_DEFAULTS = dict(
        error_not_open=-4242, _channel_index=0, _antenna_index=0,
        _freq_correction=0, _bias_tee_enabled=False, _direct_sampling_mode=0,
        bandwidth_is_adjustable=True, is_in_spectrum_mode=False,
        sending_is_continuous=False, continuous_send_ring_buffer=None,
        num_samples_to_send=None, success=0, send_buffer=None,
        send_buffer_reader=None, device_serial=None, device_number=0,
        sending_repeats=1,  # 0 = forever
        current_recv_index=0, is_receiving=False, is_transmitting=False,
        receive_buffer=None, spectrum_x=None, spectrum_y=None,
        apply_dc_correction=False,
    )

    def __init__(self, center_freq, sample_rate, bandwidth, gain, if_gain=1,
                 baseband_gain=1, resume_on_full_receive_buffer=False):
        vars(self).update(self._PARENT_STATE_DEFAULTS)
        ctor = dict(_frequency=center_freq, _sample_rate=sample_rate,
                    _bandwidth=bandwidth, _gain=gain, _if_gain=if_gain,
                    _baseband_gain=baseband_gain,
                    resume_on_full_receive_buffer=resume_on_full_receive_buffer)
        vars(self).update(ctor)

        self.error_codes = {}
        self.device_messages = []
        self._current_sent_sample = _mp.Value("L", 0)
        self._current_sending_repeat = _mp.Value("L", 0)

        self.receive_process_function = self.device_receive
        self.send_process_function = self.device_send

        self.parent_data_conn, self.child_data_conn = _mp.Pipe(duplex=False)
        self.parent_ctrl_conn, self.child_ctrl_conn = _mp.Pipe()

        # overridable per device/config (e.g. PlutoSDR ip:)
        self.device_ip = settings.read("device_ip", "192.168.10.2", str)
        self.samples_to_send = np.array([], dtype=self.DATA_TYPE)

    # -- properties with device command forwarding -------------------------
    def _forward(self, command: str, value):
        try:
            self.parent_ctrl_conn.send((command, value))
        except (BrokenPipeError, OSError):
            pass

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._install_forwarded_params()

    @classmethod
    def _install_forwarded_params(cls):
        for attr, command in cls.FORWARDED_PARAMS.items():
            if isinstance(getattr(cls, attr, None), property):
                continue

            def fget(self, _p="_" + attr):
                return getattr(self, _p)

            def fset(self, value, _p="_" + attr, _c=command):
                if value != getattr(self, _p):
                    setattr(self, _p, value)
                    self._forward(_c, value)

            setattr(cls, attr, property(fget, fset))

    @property
    def bandwidth(self):
        return self._bandwidth

    @bandwidth.setter
    def bandwidth(self, value):
        # not table-generated: gated by bandwidth_is_adjustable + int cast
        if self.bandwidth_is_adjustable and value != self._bandwidth:
            self._bandwidth = value
            self._forward("SET_BANDWIDTH", int(value))

    @property
    def has_multi_device_support(self):
        return False

    @property
    def current_sent_sample(self):
        return self._current_sent_sample.value // 2

    @current_sent_sample.setter
    def current_sent_sample(self, value: int):
        self._current_sent_sample.value = value * 2

    @property
    def current_sending_repeat(self):
        return self._current_sending_repeat.value

    @current_sending_repeat.setter
    def current_sending_repeat(self, value: int):
        self._current_sending_repeat.value = value

    # attributes shipped to the child at init, in command order
    _INIT_PARAM_ATTRS = ("frequency", "sample_rate", "bandwidth", "gain",
                         "if_gain", "baseband_gain")

    @property
    def device_parameters(self) -> OrderedDict:
        table = dict(self.FORWARDED_PARAMS, bandwidth="SET_BANDWIDTH")
        out = OrderedDict((table[attr], getattr(self, attr))
                          for attr in self._INIT_PARAM_ATTRS)
        out["identifier"] = self.device_serial
        return out

    @property
    def send_config(self) -> SendConfig:
        total_samples = (len(self.send_buffer) if self.num_samples_to_send is None
                         else 2 * self.num_samples_to_send)
        return SendConfig(self.send_buffer, self._current_sent_sample,
                          self._current_sending_repeat, total_samples,
                          self.sending_repeats, continuous=self.sending_is_continuous,
                          iq_to_bytes_method=self.iq_to_bytes,
                          continuous_send_ring_buffer=self.continuous_send_ring_buffer)

    @property
    def receive_process_arguments(self):
        return self.child_data_conn, self.child_ctrl_conn, self.device_parameters

    @property
    def send_process_arguments(self):
        return self.child_ctrl_conn, self.send_config, self.device_parameters

    @property
    def received_data(self):
        return self.receive_buffer[: self.current_recv_index]

    @property
    def sent_data(self):
        return self.samples_to_send[: self.current_sent_sample]

    @property
    def sending_finished(self):
        return self.current_sent_sample == len(self.samples_to_send)

    @property
    def data_type(self):
        return self.DATA_TYPE

    def init_recv_buffer(self):
        if self.receive_buffer is None:
            num_samples = settings.get_receive_buffer_size(
                self.resume_on_full_receive_buffer, self.is_in_spectrum_mode)
            self.receive_buffer = IQData(None, dtype=self.DATA_TYPE, n=int(num_samples))

    def log_retcode(self, retcode: int, action: str, msg=""):
        prefix = f"{type(self).__name__}-{action}" + (f" ({msg})" if msg else "")
        if retcode == self.success:
            formatted, emit = f"{prefix}: Success", logger.info
        else:
            reason = self.error_codes.get(retcode, f"Error Code: {retcode}")
            formatted, emit = f"{prefix}: {reason} ({retcode})", logger.error
        emit(formatted)
        self.device_messages.append(formatted)

    # -- lifecycle ---------------------------------------------------------
    def _start_read_rcv_buffer_thread(self):
        self.read_recv_buffer_thread = threading.Thread(target=self.read_receiving_queue,
                                                        daemon=True)
        self.read_recv_buffer_thread.start()

    def _start_read_message_thread(self):
        self.read_dev_msg_thread = threading.Thread(target=self.read_device_messages,
                                                    daemon=True)
        self.read_dev_msg_thread.start()

    def _spawn(self, process_attr: str, target, args) -> bool:
        proc = _mp.Process(target=target, args=args, daemon=True)
        setattr(self, process_attr, proc)
        self._start_read_message_thread()
        try:
            proc.start()
            return True
        except OSError as e:
            logger.error(repr(e))
            self.device_messages.append(repr(e))
            return False

    def _halt(self, process_attr: str, label: str, msg: str, extra_conns=()):
        try:
            self.parent_ctrl_conn.send(self.Command.STOP.name)
        except (BrokenPipeError, OSError):
            pass
        logger.info(f"Stopping {label}: {msg}")

        proc = getattr(self, process_attr, None)
        if proc is not None and proc.is_alive():
            proc.join(self.JOIN_TIMEOUT)
            if proc.is_alive():
                logger.warning(f"{label} process did not stop, terminating it")
                proc.terminate()
                proc.join()

        for conn in (self.parent_ctrl_conn, self.child_ctrl_conn) + tuple(extra_conns):
            conn.close()

    def start_rx_mode(self):
        self.init_recv_buffer()
        self.parent_data_conn, self.child_data_conn = _mp.Pipe(duplex=False)
        self.parent_ctrl_conn, self.child_ctrl_conn = _mp.Pipe()
        self.is_receiving = True
        self._start_read_rcv_buffer_thread()
        self._spawn("receive_process", self.receive_process_function,
                    self.receive_process_arguments)

    def stop_rx_mode(self, msg):
        self.is_receiving = False
        self._halt("receive_process", "RX", msg,
                   extra_conns=(self.parent_data_conn, self.child_data_conn))

    def start_tx_mode(self, samples_to_send: np.ndarray = None, repeats=None,
                      resume=False):
        self.is_transmitting = True
        self.parent_ctrl_conn, self.child_ctrl_conn = _mp.Pipe()
        self.init_send_parameters(samples_to_send, repeats, resume=resume)
        self._spawn("transmit_process", self.send_process_function,
                    self.send_process_arguments)

    def stop_tx_mode(self, msg):
        self.is_transmitting = False
        self._halt("transmit_process", "TX", msg)

    # -- data plane --------------------------------------------------------
    def read_device_messages(self):
        while self.is_receiving or self.is_transmitting:
            try:
                message = self.parent_ctrl_conn.recv()
            except (EOFError, UnicodeDecodeError, BrokenPipeError, OSError):
                break
            # acks look like "ACTION:retcode"; anything else is free text
            action, _, retcode = message.rpartition(":")
            try:
                self.log_retcode(int(retcode), action)
            except ValueError:
                self.device_messages.append(f"{type(self).__name__}: {message}")
        self.is_transmitting = False
        logger.debug("Exiting read device message thread")

    def _commit_samples(self, samples: np.ndarray) -> bool:
        """Place one decoded chunk into the receive buffer; False stops
        RX (buffer full without resume)."""
        n = len(samples)
        capacity = len(self.receive_buffer)
        if self.current_recv_index + n >= capacity:
            if not self.resume_on_full_receive_buffer:
                self.stop_rx_mode(
                    f"Receiving buffer is full "
                    f"{self.current_recv_index + n}/{capacity}")
                return False
            self.current_recv_index = 0
            n = min(n, capacity - 1)
        self.receive_buffer[self.current_recv_index:
                            self.current_recv_index + n] = samples[:n]
        self.current_recv_index += n
        return True

    def read_receiving_queue(self):
        while self.is_receiving:
            try:
                raw = self.parent_data_conn.recv_bytes()
            except (OSError, EOFError, BrokenPipeError):
                break
            samples = self.bytes_to_iq(raw)
            if len(samples) == 0:
                continue
            if self.apply_dc_correction:
                samples = samples - np.mean(samples, axis=0)
            if not self._commit_samples(samples):
                return
        logger.debug("Exiting read_receive_queue thread.")

    def init_send_parameters(self, samples_to_send: np.ndarray = None, repeats: int = None,
                             resume=False):
        if samples_to_send is not None:
            if isinstance(samples_to_send, IQData):
                samples_to_send = samples_to_send.data
            self.samples_to_send = samples_to_send
            self.send_buffer = None

        if repeats is not None:
            self.sending_repeats = repeats

        if self.send_buffer is None:
            if isinstance(self.samples_to_send, IQData):
                self.send_buffer = self.iq_to_bytes(self.samples_to_send.data)
            else:
                self.send_buffer = self.iq_to_bytes(self.samples_to_send)
        elif not resume:
            self.current_sending_repeat = 0

        if not resume:
            self.current_sent_sample = 0
            self.current_sending_repeat = 0

    # -- dtype conversion hooks (overridable per device) -------------------
    @classmethod
    def bytes_to_iq(cls, buffer) -> np.ndarray:
        return np.frombuffer(buffer, dtype=cls.DATA_TYPE).reshape((-1, 2), order="C")

    @classmethod
    def iq_to_bytes(cls, samples: np.ndarray):
        import multiprocessing.sharedctypes

        arr = np.asarray(samples, dtype=cls.DATA_TYPE).flatten()
        # numpy's dtype char IS the ctypes/array type code for these
        shared = multiprocessing.sharedctypes.RawArray(
            np.dtype(cls.DATA_TYPE).char, len(arr))
        np.frombuffer(shared, dtype=cls.DATA_TYPE)[:] = arr
        return shared


# __init_subclass__ covers every concrete device; the base class installs
# its own forwarded-parameter properties here
Device._install_forwarded_params()
