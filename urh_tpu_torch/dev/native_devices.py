"""Concrete native SDR devices.

Counterparts of urh/dev/native/{HackRF,RTLSDR,USRP,LimeSDR,AirSpy,
BladeRF,PlutoSDR,SDRPlay,SoundCard,Rad1o}.py.  Where the reference
binds vendor C libraries through Cython, these bind through ctypes
(found via ctypes.util.find_library at runtime); devices whose library
is absent stay importable and report unavailability through the
BackendHandler.  HackRF and RTL-SDR carry full bindings; the remaining
devices provide the runtime scaffolding (parameter maps, dtypes,
process functions) for their libraries.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import time

import numpy as np

from urh_tpu_torch.dev.device import Device
from urh_tpu_torch.util.logging import logger


def _load(*names):
    for name in names:
        path = ctypes.util.find_library(name)
        if path:
            try:
                return ctypes.CDLL(path)
            except OSError:
                continue
    return None


# ---------------------------------------------------------------------------
# HackRF (libhackrf)
# ---------------------------------------------------------------------------

class _HackRFLib:
    """ctypes binding of libhackrf's stable C API."""

    TRANSFER_CALLBACK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)

    def __init__(self):
        self.lib = _load("hackrf")
        self.dev = ctypes.c_void_p()
        self._rx_callback = None
        self._rx_sink = None

    @property
    def available(self):
        return self.lib is not None

    def setup(self, serial=None):
        if self.lib.hackrf_init() != 0:
            return False
        if serial:
            return self.lib.hackrf_open_by_serial(serial.encode(), ctypes.byref(self.dev)) == 0
        return self.lib.hackrf_open(ctypes.byref(self.dev)) == 0

    def close(self):
        if self.dev:
            self.lib.hackrf_close(self.dev)
        self.lib.hackrf_exit()

    def set_center_freq(self, freq):
        return self.lib.hackrf_set_freq(self.dev, ctypes.c_uint64(int(freq)))

    def set_sample_rate(self, rate):
        return self.lib.hackrf_set_sample_rate(self.dev, ctypes.c_double(rate))

    def set_bandwidth(self, bw):
        return self.lib.hackrf_set_baseband_filter_bandwidth(self.dev, ctypes.c_uint32(int(bw)))

    def set_rf_gain(self, gain):
        return self.lib.hackrf_set_amp_enable(self.dev, 1 if gain > 0 else 0)

    def set_if_rx_gain(self, gain):
        return self.lib.hackrf_set_lna_gain(self.dev, ctypes.c_uint32(int(gain)))

    def set_if_tx_gain(self, gain):
        return self.lib.hackrf_set_txvga_gain(self.dev, ctypes.c_uint32(int(gain)))

    def set_baseband_gain(self, gain):
        return self.lib.hackrf_set_vga_gain(self.dev, ctypes.c_uint32(int(gain)))

    def set_bias_tee(self, enabled):
        return self.lib.hackrf_set_antenna_enable(self.dev, 1 if enabled else 0)

    def start_rx(self, sink):
        """sink: callable(bytes) invoked from the libhackrf USB thread."""

        # hackrf_transfer layout: device*, buffer*, buffer_length, valid_length, ...
        class Transfer(ctypes.Structure):
            _fields_ = [("device", ctypes.c_void_p),
                        ("buffer", ctypes.POINTER(ctypes.c_ubyte)),
                        ("buffer_length", ctypes.c_int),
                        ("valid_length", ctypes.c_int)]

        def callback(transfer_ptr):
            transfer = ctypes.cast(transfer_ptr, ctypes.POINTER(Transfer)).contents
            data = ctypes.string_at(transfer.buffer, transfer.valid_length)
            try:
                sink(data)
            except (BrokenPipeError, OSError):
                return -1
            return 0

        self._rx_callback = self.TRANSFER_CALLBACK(callback)
        self._rx_sink = sink
        return self.lib.hackrf_start_rx(self.dev, self._rx_callback, None)

    def stop_rx(self):
        return self.lib.hackrf_stop_rx(self.dev)


class HackRF(Device):
    DATA_TYPE = np.int8
    ASYNCHRONOUS = True
    DEVICE_LIB = _HackRFLib() if _load("hackrf") else None

    BYTES_PER_SAMPLE = 2

    DEVICE_METHODS = dict(Device.DEVICE_METHODS)
    DEVICE_METHODS[Device.Command.SET_BIAS_TEE_ENABLED.name] = "set_bias_tee"

    @classmethod
    def setup_device(cls, ctrl_connection, device_identifier):
        if cls.DEVICE_LIB is None:
            ctrl_connection.send("libhackrf not found:-1")
            return False
        ok = cls.DEVICE_LIB.setup(device_identifier)
        ctrl_connection.send("setup hackrf:{}".format(0 if ok else -1))
        return ok

    @classmethod
    def shutdown_device(cls, ctrl_connection, is_tx: bool):
        if cls.DEVICE_LIB is not None:
            cls.DEVICE_LIB.stop_rx()
            cls.DEVICE_LIB.close()

    @classmethod
    def enter_async_receive_mode(cls, data_connection, ctrl_connection):
        return cls.DEVICE_LIB.start_rx(data_connection.send_bytes)

    @classmethod
    def adapt_num_read_samples_to_sample_rate(cls, sample_rate):
        pass

    @classmethod
    def bytes_to_iq(cls, buffer):
        return np.frombuffer(buffer, dtype=np.int8).reshape((-1, 2), order="C")

    @classmethod
    def iq_to_bytes(cls, samples):
        import multiprocessing.sharedctypes

        arr = np.asarray(samples, dtype=np.int8).flatten()
        result = multiprocessing.sharedctypes.RawArray("b", len(arr))
        np.frombuffer(result, dtype=np.int8)[:] = arr
        return result

    def __init__(self, center_freq, sample_rate, bandwidth, gain, if_gain=1,
                 baseband_gain=1, resume_on_full_receive_buffer=False):
        super().__init__(center_freq, sample_rate, bandwidth, gain, if_gain,
                         baseband_gain, resume_on_full_receive_buffer)
        self.success = 0
        self.error_codes = {
            0: "HACKRF_SUCCESS", 1: "HACKRF_TRUE",
            1337: "TIMEOUT ERROR", -2: "HACKRF_ERROR_INVALID_PARAM",
            -5: "HACKRF_ERROR_NOT_FOUND", -6: "HACKRF_ERROR_BUSY",
            -11: "HACKRF_ERROR_NO_MEM", -1000: "HACKRF_ERROR_LIBUSB",
            -1001: "HACKRF_ERROR_THREAD", -1002: "HACKRF_ERROR_STREAMING_THREAD_ERR",
            -1003: "HACKRF_ERROR_STREAMING_STOPPED", -1004: "HACKRF_ERROR_STREAMING_EXIT_CALLED",
            -4242: "HACKRF NOT OPEN", -9999: "HACKRF_ERROR_OTHER",
        }
        self.bandwidth_is_adjustable = True


class Rad1o(HackRF):
    """rad1o badge speaks the HackRF protocol."""


# ---------------------------------------------------------------------------
# RTL-SDR (librtlsdr)
# ---------------------------------------------------------------------------

class _RTLSDRLib:
    def __init__(self):
        self.lib = _load("rtlsdr")
        self.dev = ctypes.c_void_p()

    @property
    def available(self):
        return self.lib is not None

    def setup(self, device_number=0):
        return self.lib.rtlsdr_open(ctypes.byref(self.dev), int(device_number)) == 0

    def close(self):
        if self.dev:
            self.lib.rtlsdr_close(self.dev)

    def set_center_freq(self, freq):
        return self.lib.rtlsdr_set_center_freq(self.dev, ctypes.c_uint32(int(freq)))

    def set_sample_rate(self, rate):
        return self.lib.rtlsdr_set_sample_rate(self.dev, ctypes.c_uint32(int(rate)))

    def set_bandwidth(self, bw):
        if hasattr(self.lib, "rtlsdr_set_tuner_bandwidth"):
            return self.lib.rtlsdr_set_tuner_bandwidth(self.dev, ctypes.c_uint32(int(bw)))
        return 0

    def set_rf_gain(self, gain):
        self.lib.rtlsdr_set_tuner_gain_mode(self.dev, 1)
        return self.lib.rtlsdr_set_tuner_gain(self.dev, int(gain * 10))

    def set_freq_correction(self, ppm):
        return self.lib.rtlsdr_set_freq_correction(self.dev, int(ppm))

    def set_direct_sampling(self, mode):
        return self.lib.rtlsdr_set_direct_sampling(self.dev, int(mode))

    def reset_buffer(self):
        return self.lib.rtlsdr_reset_buffer(self.dev)

    def read_sync(self, num_bytes=65536):
        buf = (ctypes.c_ubyte * num_bytes)()
        n_read = ctypes.c_int(0)
        ret = self.lib.rtlsdr_read_sync(self.dev, buf, num_bytes, ctypes.byref(n_read))
        if ret != 0:
            return b""
        return bytes(buf[: n_read.value])


class RTLSDR(Device):
    DATA_TYPE = np.int8
    ASYNCHRONOUS = False
    DEVICE_LIB = _RTLSDRLib() if _load("rtlsdr") else None
    SYNC_RX_CHUNK_SIZE = 65536

    DEVICE_METHODS = dict(Device.DEVICE_METHODS)
    DEVICE_METHODS[Device.Command.SET_FREQUENCY_CORRECTION.name] = "set_freq_correction"
    DEVICE_METHODS[Device.Command.SET_DIRECT_SAMPLING_MODE.name] = "set_direct_sampling"

    @classmethod
    def setup_device(cls, ctrl_connection, device_identifier):
        if cls.DEVICE_LIB is None:
            ctrl_connection.send("librtlsdr not found:-1")
            return False
        try:
            number = int(device_identifier) if device_identifier else 0
        except ValueError:
            number = 0
        ok = cls.DEVICE_LIB.setup(number)
        if ok:
            cls.DEVICE_LIB.reset_buffer()
        ctrl_connection.send("setup rtl-sdr:{}".format(0 if ok else -1))
        return ok

    @classmethod
    def shutdown_device(cls, ctrl_connection, is_tx: bool):
        if cls.DEVICE_LIB is not None:
            cls.DEVICE_LIB.close()

    @classmethod
    def prepare_sync_receive(cls, ctrl_connection):
        return 0

    @classmethod
    def receive_sync(cls, data_conn):
        data_conn.send_bytes(cls.DEVICE_LIB.read_sync(cls.SYNC_RX_CHUNK_SIZE))

    @classmethod
    def adapt_num_read_samples_to_sample_rate(cls, sample_rate):
        pass

    @classmethod
    def bytes_to_iq(cls, buffer):
        # rtl-sdr delivers unsigned bytes centered at 127
        return np.subtract(np.frombuffer(buffer, dtype=np.uint8), 127).astype(np.int8).reshape((-1, 2), order="C")

    def __init__(self, freq, gain, srate, device_number=0,
                 resume_on_full_receive_buffer=False):
        super().__init__(center_freq=freq, sample_rate=srate, bandwidth=srate,
                         gain=gain, resume_on_full_receive_buffer=resume_on_full_receive_buffer)
        self.device_number = device_number
        self.success = 0
        self.bandwidth_is_adjustable = True


# ---------------------------------------------------------------------------
# Remaining vendor devices: ctypes bindings live in urh_tpu_torch.dev.vendor_libs
# (counterparts of the lib/*.pyx wrappers); these classes provide the
# process-runtime glue exactly like HackRF/RTLSDR above.
# ---------------------------------------------------------------------------

from urh_tpu_torch.dev import vendor_libs as _vendor


class _SyncVendorDevice(Device):
    """Shared runtime glue for sync-streaming vendor devices."""

    ASYNCHRONOUS = False
    LIB_CLASS = None

    @classmethod
    def setup_device(cls, ctrl_connection, device_identifier):
        if cls.DEVICE_LIB is None or not cls.DEVICE_LIB.available:
            ctrl_connection.send("{} vendor library not found:-1".format(cls.__name__))
            return False
        ok = cls.DEVICE_LIB.setup(device_identifier)
        ctrl_connection.send("setup {}:{}".format(cls.__name__.lower(), 0 if ok else -1))
        return ok

    @classmethod
    def shutdown_device(cls, ctrl_connection, is_tx: bool):
        if cls.DEVICE_LIB is not None and cls.DEVICE_LIB.available:
            cls.DEVICE_LIB.close()

    @classmethod
    def receive_sync(cls, data_conn):
        data = cls.DEVICE_LIB.receive_sync()
        if data:
            data_conn.send_bytes(data)

    @classmethod
    def adapt_num_read_samples_to_sample_rate(cls, sample_rate):
        pass


class USRP(_SyncVendorDevice):
    """urh/dev/native/USRP.py + lib/usrp.pyx via the UHD C API."""

    DATA_TYPE = np.float32
    DEVICE_LIB = _vendor.USRPLib() if _vendor._load("uhd") else None

    DEVICE_METHODS = dict(Device.DEVICE_METHODS)
    DEVICE_METHODS[Device.Command.SET_RF_GAIN.name] = "set_rf_gain"
    DEVICE_METHODS[Device.Command.SET_ANTENNA_INDEX.name] = "set_antenna"

    @classmethod
    def prepare_sync_receive(cls, ctrl_connection):
        return 0 if cls.DEVICE_LIB.start_stream() else -1

    @classmethod
    def shutdown_device(cls, ctrl_connection, is_tx: bool):
        if cls.DEVICE_LIB is not None and cls.DEVICE_LIB.available:
            cls.DEVICE_LIB.stop_stream()
            cls.DEVICE_LIB.close()

    @classmethod
    def bytes_to_iq(cls, buffer):
        return np.frombuffer(buffer, dtype=np.float32).reshape((-1, 2), order="C")


class LimeSDR(_SyncVendorDevice):
    """urh/dev/native/LimeSDR.py + lib/limesdr.pyx via libLimeSuite."""

    DATA_TYPE = np.float32
    DEVICE_LIB = _vendor.LimeSDRLib() if _vendor._load("LimeSuite") else None

    DEVICE_METHODS = dict(Device.DEVICE_METHODS)
    DEVICE_METHODS[Device.Command.SET_RF_GAIN.name] = "set_normalized_gain"
    DEVICE_METHODS[Device.Command.SET_ANTENNA_INDEX.name] = "set_antenna"

    @classmethod
    def prepare_sync_receive(cls, ctrl_connection):
        return 0 if cls.DEVICE_LIB.setup_stream() else -1

    @classmethod
    def shutdown_device(cls, ctrl_connection, is_tx: bool):
        if cls.DEVICE_LIB is not None and cls.DEVICE_LIB.available:
            cls.DEVICE_LIB.stop_stream()
            cls.DEVICE_LIB.close()

    @classmethod
    def bytes_to_iq(cls, buffer):
        return np.frombuffer(buffer, dtype=np.float32).reshape((-1, 2), order="C")


class BladeRF(_SyncVendorDevice):
    """urh/dev/native/BladeRF.py + lib/bladerf.pyx via libbladeRF."""

    DATA_TYPE = np.int16
    DEVICE_LIB = _vendor.BladeRFLib() if _vendor._load("bladeRF") else None

    DEVICE_METHODS = dict(Device.DEVICE_METHODS)
    DEVICE_METHODS[Device.Command.SET_RF_GAIN.name] = "set_gain"
    DEVICE_METHODS[Device.Command.SET_BIAS_TEE_ENABLED.name] = "set_bias_tee"

    @classmethod
    def prepare_sync_receive(cls, ctrl_connection):
        return 0

    @classmethod
    def bytes_to_iq(cls, buffer):
        return np.frombuffer(buffer, dtype=np.int16).reshape((-1, 2), order="C")


class PlutoSDR(_SyncVendorDevice):
    """urh/dev/native/PlutoSDR.py + lib/plutosdr.pyx via libiio."""

    DATA_TYPE = np.int16
    DEVICE_LIB = _vendor.PlutoSDRLib() if _vendor._load("iio") else None

    @classmethod
    def prepare_sync_receive(cls, ctrl_connection):
        return 0 if cls.DEVICE_LIB.create_buffer() else -1

    @classmethod
    def bytes_to_iq(cls, buffer):
        return np.frombuffer(buffer, dtype=np.int16).reshape((-1, 2), order="C")


class AirSpy(Device):
    """urh/dev/native/AirSpy.py + lib/airspy.pyx via libairspy (async RX)."""

    DATA_TYPE = np.float32
    ASYNCHRONOUS = True
    DEVICE_LIB = _vendor.AirSpyLib() if _vendor._load("airspy") else None

    DEVICE_METHODS = dict(Device.DEVICE_METHODS)
    DEVICE_METHODS.pop(Device.Command.SET_BANDWIDTH.name, None)

    @classmethod
    def setup_device(cls, ctrl_connection, device_identifier):
        if cls.DEVICE_LIB is None or not cls.DEVICE_LIB.available:
            ctrl_connection.send("libairspy not found:-1")
            return False
        ok = cls.DEVICE_LIB.setup(device_identifier)
        ctrl_connection.send("setup airspy:{}".format(0 if ok else -1))
        return ok

    @classmethod
    def shutdown_device(cls, ctrl_connection, is_tx: bool):
        if cls.DEVICE_LIB is not None and cls.DEVICE_LIB.available:
            cls.DEVICE_LIB.stop_rx()
            cls.DEVICE_LIB.close()

    @classmethod
    def enter_async_receive_mode(cls, data_connection, ctrl_connection):
        return cls.DEVICE_LIB.start_rx(data_connection.send_bytes)

    @classmethod
    def adapt_num_read_samples_to_sample_rate(cls, sample_rate):
        pass

    @classmethod
    def bytes_to_iq(cls, buffer):
        return np.frombuffer(buffer, dtype=np.float32).reshape((-1, 2), order="C")


class SDRPlay(Device):
    """urh/dev/native/SDRPlay.py + lib/sdrplay.pyx via mir_sdr (async RX)."""

    DATA_TYPE = np.int16
    ASYNCHRONOUS = True
    DEVICE_LIB = (_vendor.SDRPlayLib()
                  if _vendor._load("mirsdrapi-rsp", "sdrplay_api") else None)

    DEVICE_METHODS = dict(Device.DEVICE_METHODS)
    DEVICE_METHODS[Device.Command.SET_RF_GAIN.name] = "set_gain"
    DEVICE_METHODS[Device.Command.SET_IF_GAIN.name] = {"rx": "set_if_gain"}
    DEVICE_METHODS[Device.Command.SET_ANTENNA_INDEX.name] = "set_antenna"

    @classmethod
    def setup_device(cls, ctrl_connection, device_identifier):
        if cls.DEVICE_LIB is None or not cls.DEVICE_LIB.available:
            ctrl_connection.send("SDRPlay API library not found:-1")
            return False
        ok = cls.DEVICE_LIB.setup(device_identifier)
        ctrl_connection.send("setup sdrplay:{}".format(0 if ok else -1))
        return ok

    @classmethod
    def shutdown_device(cls, ctrl_connection, is_tx: bool):
        if cls.DEVICE_LIB is not None and cls.DEVICE_LIB.available:
            cls.DEVICE_LIB.close()

    @classmethod
    def enter_async_receive_mode(cls, data_connection, ctrl_connection):
        return cls.DEVICE_LIB.start_rx(data_connection.send_bytes)

    @classmethod
    def adapt_num_read_samples_to_sample_rate(cls, sample_rate):
        pass

    @classmethod
    def bytes_to_iq(cls, buffer):
        return np.frombuffer(buffer, dtype=np.int16).reshape((-1, 2), order="C")


class SoundCard(Device):
    """Audio-band IQ via pyaudio (urh/dev/native/SoundCard.py)."""

    DATA_TYPE = np.float32
    ASYNCHRONOUS = False
    SYNC_RX_CHUNK_SIZE = 4096
    pyaudio_handle = None

    @classmethod
    def setup_device(cls, ctrl_connection, device_identifier):
        try:
            import pyaudio
        except ImportError:
            ctrl_connection.send("pyaudio not installed:-1")
            return False
        cls.pyaudio_handle = pyaudio.PyAudio()
        ctrl_connection.send("setup soundcard:0")
        return True

    @classmethod
    def prepare_sync_receive(cls, ctrl_connection):
        import pyaudio

        cls.stream = cls.pyaudio_handle.open(format=pyaudio.paFloat32, channels=2,
                                             rate=48000, input=True,
                                             frames_per_buffer=cls.SYNC_RX_CHUNK_SIZE)
        return 0

    @classmethod
    def receive_sync(cls, data_conn):
        data_conn.send_bytes(cls.stream.read(cls.SYNC_RX_CHUNK_SIZE,
                                             exception_on_overflow=False))

    @classmethod
    def adapt_num_read_samples_to_sample_rate(cls, sample_rate):
        pass
