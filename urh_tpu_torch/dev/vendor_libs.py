"""ctypes bindings of the remaining vendor SDR libraries.

Counterparts of the Cython wrappers in urh/dev/native/lib/{airspy,
bladerf,limesdr,plutosdr,usrp,sdrplay}.pyx: each class lazily loads the
vendor shared library (ctypes.util.find_library), reports availability,
and exposes setup/close, set_* parameter methods and sync or async
sample streaming over the same method names the Device command
dispatcher uses.  Absent libraries keep everything importable.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

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
# AirSpy (libairspy) -- async RX only, float32 IQ (airspy.pyx:1-90)
# ---------------------------------------------------------------------------

class AirSpyTransfer(ctypes.Structure):
    _fields_ = [
        ("device", ctypes.c_void_p),
        ("ctx", ctypes.c_void_p),
        ("samples", ctypes.c_void_p),
        ("sample_count", ctypes.c_int),
        ("dropped_samples", ctypes.c_uint64),
        ("sample_type", ctypes.c_int),
    ]


class AirSpyLib:
    CALLBACK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(AirSpyTransfer))
    SAMPLE_FLOAT32_IQ = 0

    def __init__(self):
        self.lib = _load("airspy")
        self.dev = ctypes.c_void_p()
        self._cb = None
        self._sink = None

    @property
    def available(self):
        return self.lib is not None

    def setup(self, serial=None):
        if serial:
            ret = self.lib.airspy_open_sn(ctypes.byref(self.dev),
                                          ctypes.c_uint64(int(serial, 16)))
        else:
            ret = self.lib.airspy_open(ctypes.byref(self.dev))
        if ret != 0:
            return False
        self.lib.airspy_set_sample_type(self.dev, self.SAMPLE_FLOAT32_IQ)
        return True

    def close(self):
        if self.dev:
            self.lib.airspy_close(self.dev)
            self.dev = ctypes.c_void_p()

    def set_center_freq(self, freq):
        return self.lib.airspy_set_freq(self.dev, ctypes.c_uint32(int(freq)))

    def set_sample_rate(self, rate):
        return self.lib.airspy_set_samplerate(self.dev, ctypes.c_uint32(int(rate)))

    def set_rf_gain(self, gain):
        return self.lib.airspy_set_vga_gain(self.dev, ctypes.c_uint8(int(gain)))

    def set_if_rx_gain(self, gain):
        return self.lib.airspy_set_mixer_gain(self.dev, ctypes.c_uint8(int(gain)))

    def set_baseband_gain(self, gain):
        return self.lib.airspy_set_lna_gain(self.dev, ctypes.c_uint8(int(gain)))

    def start_rx(self, sink):
        self._sink = sink

        def callback(transfer_ptr):
            t = transfer_ptr.contents
            n_floats = 2 * t.sample_count
            buf = ctypes.string_at(t.samples, n_floats * 4)
            try:
                self._sink(buf)
            except (BrokenPipeError, OSError) as e:
                logger.warning("AirSpy RX: " + str(e))
            return 0

        self._cb = self.CALLBACK(callback)
        return self.lib.airspy_start_rx(self.dev, self._cb, None)

    def stop_rx(self):
        if self.dev:
            self.lib.airspy_stop_rx(self.dev)


# ---------------------------------------------------------------------------
# BladeRF (libbladeRF) -- sync RX/TX, SC16 Q11 int16 (bladerf.pyx)
# ---------------------------------------------------------------------------

class BladeRFLib:
    CHANNEL_RX0 = 0  # BLADERF_CHANNEL_RX(0) = (0 << 1) | 0
    CHANNEL_TX0 = 1  # BLADERF_CHANNEL_TX(0) = (0 << 1) | 1
    LAYOUT_RX_X1 = 0
    LAYOUT_TX_X1 = 1
    FORMAT_SC16_Q11 = 0
    TIMEOUT_MS = 500
    SYNC_RX_CHUNK_SIZE = 65536

    def __init__(self):
        self.lib = _load("bladeRF")
        self.dev = ctypes.c_void_p()
        self.is_tx = False
        if self.lib is not None:
            self.lib.bladerf_open.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                              ctypes.c_char_p]
            self.lib.bladerf_set_frequency.argtypes = [ctypes.c_void_p,
                                                       ctypes.c_int,
                                                       ctypes.c_uint64]

    @property
    def available(self):
        return self.lib is not None

    @property
    def channel(self):
        return self.CHANNEL_TX0 if self.is_tx else self.CHANNEL_RX0

    def setup(self, device_identifier=None):
        ident = device_identifier.encode() if device_identifier else None
        if self.lib.bladerf_open(ctypes.byref(self.dev), ident) != 0:
            return False
        layout = self.LAYOUT_TX_X1 if self.is_tx else self.LAYOUT_RX_X1
        self.lib.bladerf_sync_config(self.dev, layout, self.FORMAT_SC16_Q11,
                                     ctypes.c_uint(32), ctypes.c_uint(65536),
                                     ctypes.c_uint(16), ctypes.c_uint(self.TIMEOUT_MS))
        self.lib.bladerf_enable_module(self.dev, self.channel, True)
        return True

    def close(self):
        if self.dev:
            self.lib.bladerf_enable_module(self.dev, self.channel, False)
            self.lib.bladerf_close(self.dev)
            self.dev = ctypes.c_void_p()

    def set_center_freq(self, freq):
        return self.lib.bladerf_set_frequency(self.dev, self.channel,
                                              ctypes.c_uint64(int(freq)))

    def set_sample_rate(self, rate):
        actual = ctypes.c_uint32()
        return self.lib.bladerf_set_sample_rate(self.dev, self.channel,
                                                ctypes.c_uint32(int(rate)),
                                                ctypes.byref(actual))

    def set_bandwidth(self, bw):
        actual = ctypes.c_uint32()
        return self.lib.bladerf_set_bandwidth(self.dev, self.channel,
                                              ctypes.c_uint32(int(bw)),
                                              ctypes.byref(actual))

    def set_gain(self, gain):
        return self.lib.bladerf_set_gain(self.dev, self.channel, ctypes.c_int(int(gain)))

    def set_bias_tee(self, enabled):
        return self.lib.bladerf_set_bias_tee(self.dev, self.channel, bool(enabled))

    def receive_sync(self):
        n = self.SYNC_RX_CHUNK_SIZE
        buf = (ctypes.c_int16 * (2 * n))()
        ret = self.lib.bladerf_sync_rx(self.dev, buf, ctypes.c_uint(n), None,
                                       ctypes.c_uint(self.TIMEOUT_MS))
        if ret != 0:
            return b""
        return bytes(buf)

    def send_sync(self, samples: np.ndarray):
        samples = np.ascontiguousarray(samples, dtype=np.int16)
        n = len(samples) // 2
        return self.lib.bladerf_sync_tx(
            self.dev, samples.ctypes.data_as(ctypes.c_void_p), ctypes.c_uint(n),
            None, ctypes.c_uint(self.TIMEOUT_MS))


# ---------------------------------------------------------------------------
# LimeSDR (libLimeSuite) -- stream-based RX/TX, float32 (limesdr.pyx)
# ---------------------------------------------------------------------------

class LmsStream(ctypes.Structure):
    _fields_ = [
        ("handle", ctypes.c_size_t),
        ("isTx", ctypes.c_bool),
        ("channel", ctypes.c_uint32),
        ("fifoSize", ctypes.c_uint32),
        ("throughputVsLatency", ctypes.c_float),
        ("dataFmt", ctypes.c_int),
    ]


class LmsStreamMeta(ctypes.Structure):
    _fields_ = [
        ("timestamp", ctypes.c_uint64),
        ("waitForTimestamp", ctypes.c_bool),
        ("flushPartialPacket", ctypes.c_bool),
    ]


class LimeSDRLib:
    FMT_F32 = 0
    TIMEOUT_MS = 100
    SYNC_RX_CHUNK_SIZE = 32768

    def __init__(self):
        self.lib = _load("LimeSuite")
        self.dev = ctypes.c_void_p()
        self.stream = LmsStream()
        self.is_tx = False
        self.channel = 0
        if self.lib is not None:
            self.lib.LMS_SetLOFrequency.argtypes = [ctypes.c_void_p, ctypes.c_bool,
                                                    ctypes.c_size_t, ctypes.c_double]
            self.lib.LMS_SetSampleRate.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                                   ctypes.c_size_t]
            self.lib.LMS_SetNormalizedGain.argtypes = [ctypes.c_void_p, ctypes.c_bool,
                                                       ctypes.c_size_t, ctypes.c_double]
            self.lib.LMS_SetLPFBW.argtypes = [ctypes.c_void_p, ctypes.c_bool,
                                              ctypes.c_size_t, ctypes.c_double]

    @property
    def available(self):
        return self.lib is not None

    def setup(self, device_identifier=None):
        info_list = (ctypes.c_char * 256 * 8)()
        n = self.lib.LMS_GetDeviceList(info_list)
        if n <= 0:
            return False
        index = 0
        if device_identifier:
            for i in range(n):
                if device_identifier in bytes(info_list[i]).decode(errors="ignore"):
                    index = i
                    break
        if self.lib.LMS_Open(ctypes.byref(self.dev), info_list[index], None) != 0:
            return False
        self.lib.LMS_Init(self.dev)
        self.lib.LMS_EnableChannel(self.dev, self.is_tx, self.channel, True)
        return True

    def close(self):
        if self.dev:
            self.lib.LMS_Close(self.dev)
            self.dev = ctypes.c_void_p()

    def set_center_freq(self, freq):
        return self.lib.LMS_SetLOFrequency(self.dev, self.is_tx, self.channel, float(freq))

    def set_sample_rate(self, rate):
        return self.lib.LMS_SetSampleRate(self.dev, float(rate), 0)

    def set_bandwidth(self, bw):
        return self.lib.LMS_SetLPFBW(self.dev, self.is_tx, self.channel, float(bw))

    def set_normalized_gain(self, gain):
        return self.lib.LMS_SetNormalizedGain(self.dev, self.is_tx, self.channel,
                                              float(gain))

    def set_antenna(self, index):
        return self.lib.LMS_SetAntenna(self.dev, self.is_tx, self.channel, int(index))

    def calibrate(self, bw):
        return self.lib.LMS_Calibrate(self.dev, self.is_tx, self.channel, float(bw), 0)

    def setup_stream(self):
        self.stream = LmsStream(handle=0, isTx=self.is_tx, channel=self.channel,
                                fifoSize=4 * self.SYNC_RX_CHUNK_SIZE,
                                throughputVsLatency=0.5, dataFmt=self.FMT_F32)
        if self.lib.LMS_SetupStream(self.dev, ctypes.byref(self.stream)) != 0:
            return False
        return self.lib.LMS_StartStream(ctypes.byref(self.stream)) == 0

    def receive_sync(self):
        n = self.SYNC_RX_CHUNK_SIZE
        buf = (ctypes.c_float * (2 * n))()
        received = self.lib.LMS_RecvStream(ctypes.byref(self.stream), buf,
                                           ctypes.c_size_t(n), None, self.TIMEOUT_MS)
        if received <= 0:
            return b""
        return ctypes.string_at(buf, 8 * received)

    def send_sync(self, samples: np.ndarray):
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        n = len(samples) // 2
        return self.lib.LMS_SendStream(
            ctypes.byref(self.stream), samples.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_size_t(n), None, self.TIMEOUT_MS)

    def stop_stream(self):
        self.lib.LMS_StopStream(ctypes.byref(self.stream))
        self.lib.LMS_DestroyStream(self.dev, ctypes.byref(self.stream))


# ---------------------------------------------------------------------------
# PlutoSDR (libiio) -- buffer-based RX, int16 (plutosdr.pyx)
# ---------------------------------------------------------------------------

class PlutoSDRLib:
    SYNC_RX_CHUNK_SIZE = 32768

    def __init__(self):
        self.lib = _load("iio")
        self.ctx = None
        self.phy = None
        self.rx_dev = None
        self.buffer = None
        self.rx_channels = []
        if self.lib is not None:
            self.lib.iio_create_context_from_uri.restype = ctypes.c_void_p
            self.lib.iio_create_default_context.restype = ctypes.c_void_p
            self.lib.iio_context_find_device.restype = ctypes.c_void_p
            self.lib.iio_context_find_device.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            self.lib.iio_device_find_channel.restype = ctypes.c_void_p
            self.lib.iio_device_find_channel.argtypes = [ctypes.c_void_p,
                                                         ctypes.c_char_p, ctypes.c_bool]
            self.lib.iio_channel_attr_write_longlong.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]
            self.lib.iio_channel_attr_write.argtypes = [ctypes.c_void_p,
                                                        ctypes.c_char_p, ctypes.c_char_p]
            self.lib.iio_device_create_buffer.restype = ctypes.c_void_p
            self.lib.iio_device_create_buffer.argtypes = [ctypes.c_void_p,
                                                          ctypes.c_size_t, ctypes.c_bool]
            self.lib.iio_buffer_first.restype = ctypes.c_void_p
            self.lib.iio_buffer_first.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            self.lib.iio_buffer_end.restype = ctypes.c_void_p
            self.lib.iio_buffer_end.argtypes = [ctypes.c_void_p]
            self.lib.iio_channel_enable.argtypes = [ctypes.c_void_p]
            self.lib.iio_buffer_refill.argtypes = [ctypes.c_void_p]
            self.lib.iio_buffer_destroy.argtypes = [ctypes.c_void_p]
            self.lib.iio_context_destroy.argtypes = [ctypes.c_void_p]

    @property
    def available(self):
        return self.lib is not None

    def setup(self, uri=None):
        if uri:
            self.ctx = self.lib.iio_create_context_from_uri(uri.encode())
        else:
            self.ctx = self.lib.iio_create_default_context()
        if not self.ctx:
            return False
        self.phy = self.lib.iio_context_find_device(self.ctx, b"ad9361-phy")
        self.rx_dev = self.lib.iio_context_find_device(self.ctx, b"cf-ad9361-lpc")
        if not self.phy or not self.rx_dev:
            return False
        for name in (b"voltage0", b"voltage1"):
            ch = self.lib.iio_device_find_channel(self.rx_dev, name, False)
            if ch:
                self.lib.iio_channel_enable(ch)
                self.rx_channels.append(ch)
        # manual gain control by default, as the reference does
        gain_ch = self.lib.iio_device_find_channel(self.phy, b"voltage0", False)
        if gain_ch:
            self.lib.iio_channel_attr_write(gain_ch, b"gain_control_mode", b"manual")
        return True

    def close(self):
        if self.buffer:
            self.lib.iio_buffer_destroy(self.buffer)
            self.buffer = None
        if self.ctx:
            self.lib.iio_context_destroy(self.ctx)
            self.ctx = None

    def _phy_write(self, channel: bytes, is_output: bool, attr: bytes, value: int):
        ch = self.lib.iio_device_find_channel(self.phy, channel, is_output)
        if not ch:
            return -1
        return self.lib.iio_channel_attr_write_longlong(ch, attr, int(value))

    def set_center_freq(self, freq):
        # RX LO lives on output channel altvoltage0
        return self._phy_write(b"altvoltage0", True, b"frequency", int(freq))

    def set_sample_rate(self, rate):
        return self._phy_write(b"voltage0", False, b"sampling_frequency", int(rate))

    def set_bandwidth(self, bw):
        return self._phy_write(b"voltage0", False, b"rf_bandwidth", int(bw))

    def set_rf_gain(self, gain):
        return self._phy_write(b"voltage0", False, b"hardwaregain", int(gain))

    def create_buffer(self):
        self.buffer = self.lib.iio_device_create_buffer(
            self.rx_dev, ctypes.c_size_t(self.SYNC_RX_CHUNK_SIZE), False)
        return bool(self.buffer)

    def receive_sync(self):
        if not self.buffer and not self.create_buffer():
            return b""
        nbytes = self.lib.iio_buffer_refill(self.buffer)
        if nbytes <= 0:
            return b""
        start = self.lib.iio_buffer_first(self.buffer, self.rx_channels[0])
        return ctypes.string_at(start, nbytes)


# ---------------------------------------------------------------------------
# USRP (libuhd C API) -- streamer-based RX/TX, float32 (usrp.pyx)
# ---------------------------------------------------------------------------

class UhdTuneRequest(ctypes.Structure):
    _fields_ = [
        ("target_freq", ctypes.c_double),
        ("rf_freq_policy", ctypes.c_int),
        ("rf_freq", ctypes.c_double),
        ("dsp_freq_policy", ctypes.c_int),
        ("dsp_freq", ctypes.c_double),
        ("args", ctypes.c_char_p),
    ]


class UhdTuneResult(ctypes.Structure):
    _fields_ = [
        ("clipped_rf_freq", ctypes.c_double),
        ("target_rf_freq", ctypes.c_double),
        ("actual_rf_freq", ctypes.c_double),
        ("target_dsp_freq", ctypes.c_double),
        ("actual_dsp_freq", ctypes.c_double),
    ]


class UhdStreamArgs(ctypes.Structure):
    _fields_ = [
        ("cpu_format", ctypes.c_char_p),
        ("otw_format", ctypes.c_char_p),
        ("args", ctypes.c_char_p),
        ("channel_list", ctypes.POINTER(ctypes.c_size_t)),
        ("n_channels", ctypes.c_int),
    ]


class UhdStreamCmd(ctypes.Structure):
    _fields_ = [
        ("stream_mode", ctypes.c_int),
        ("num_samps", ctypes.c_size_t),
        ("stream_now", ctypes.c_bool),
        ("time_spec_full_secs", ctypes.c_int64),
        ("time_spec_frac_secs", ctypes.c_double),
    ]


class USRPLib:
    TUNE_POLICY_AUTO = 65  # 'A'
    STREAM_MODE_START_CONTINUOUS = 97  # 'a'
    STREAM_MODE_STOP_CONTINUOUS = 111  # 'o'
    SYNC_RX_CHUNK_SIZE = 32768

    def __init__(self):
        self.lib = _load("uhd")
        self.handle = ctypes.c_void_p()
        self.rx_streamer = ctypes.c_void_p()
        self.rx_metadata = ctypes.c_void_p()
        self.channel = ctypes.c_size_t(0)
        if self.lib is not None:
            self.lib.uhd_usrp_set_rx_rate.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                                      ctypes.c_size_t]
            self.lib.uhd_usrp_set_rx_gain.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                                      ctypes.c_size_t, ctypes.c_char_p]
            self.lib.uhd_usrp_set_rx_bandwidth.argtypes = [ctypes.c_void_p,
                                                           ctypes.c_double,
                                                           ctypes.c_size_t]
            self.lib.uhd_rx_streamer_recv.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_double, ctypes.c_bool,
                ctypes.POINTER(ctypes.c_size_t)]

    @property
    def available(self):
        return self.lib is not None

    def setup(self, device_args=""):
        if self.lib.uhd_usrp_make(ctypes.byref(self.handle),
                                  (device_args or "").encode()) != 0:
            return False
        self.lib.uhd_rx_streamer_make(ctypes.byref(self.rx_streamer))
        self.lib.uhd_rx_metadata_make(ctypes.byref(self.rx_metadata))
        return True

    def close(self):
        if self.rx_streamer:
            self.lib.uhd_rx_streamer_free(ctypes.byref(self.rx_streamer))
        if self.rx_metadata:
            self.lib.uhd_rx_metadata_free(ctypes.byref(self.rx_metadata))
        if self.handle:
            self.lib.uhd_usrp_free(ctypes.byref(self.handle))
            self.handle = ctypes.c_void_p()

    def set_center_freq(self, freq):
        request = UhdTuneRequest(target_freq=float(freq),
                                 rf_freq_policy=self.TUNE_POLICY_AUTO,
                                 dsp_freq_policy=self.TUNE_POLICY_AUTO, args=None)
        result = UhdTuneResult()
        return self.lib.uhd_usrp_set_rx_freq(self.handle, ctypes.byref(request),
                                             self.channel, ctypes.byref(result))

    def set_sample_rate(self, rate):
        return self.lib.uhd_usrp_set_rx_rate(self.handle, float(rate), self.channel)

    def set_bandwidth(self, bw):
        return self.lib.uhd_usrp_set_rx_bandwidth(self.handle, float(bw), self.channel)

    def set_rf_gain(self, normalized_gain):
        return self.lib.uhd_usrp_set_rx_gain(self.handle, float(normalized_gain),
                                             self.channel, b"")

    def set_antenna(self, index):
        return 0  # antenna selection is by name in UHD; index map is device specific

    def start_stream(self):
        channels = (ctypes.c_size_t * 1)(0)
        args = UhdStreamArgs(cpu_format=b"fc32", otw_format=b"sc16", args=b"",
                             channel_list=channels, n_channels=1)
        if self.lib.uhd_usrp_get_rx_stream(self.handle, ctypes.byref(args),
                                           self.rx_streamer) != 0:
            return False
        cmd = UhdStreamCmd(stream_mode=self.STREAM_MODE_START_CONTINUOUS,
                           num_samps=0, stream_now=True)
        return self.lib.uhd_rx_streamer_issue_stream_cmd(
            self.rx_streamer, ctypes.byref(cmd)) == 0

    def receive_sync(self):
        n = self.SYNC_RX_CHUNK_SIZE
        buf = (ctypes.c_float * (2 * n))()
        buffs = (ctypes.c_void_p * 1)(ctypes.addressof(buf))
        received = ctypes.c_size_t(0)
        self.lib.uhd_rx_streamer_recv(self.rx_streamer, buffs, ctypes.c_size_t(n),
                                      ctypes.byref(self.rx_metadata), 3.0, False,
                                      ctypes.byref(received))
        return bytes(memoryview(buf).cast("B"))[: 8 * received.value]

    def stop_stream(self):
        cmd = UhdStreamCmd(stream_mode=self.STREAM_MODE_STOP_CONTINUOUS,
                           num_samps=0, stream_now=True)
        self.lib.uhd_rx_streamer_issue_stream_cmd(self.rx_streamer, ctypes.byref(cmd))


# ---------------------------------------------------------------------------
# SDRPlay (mir_sdr v2 API) -- async RX, int16 (sdrplay.pyx)
# ---------------------------------------------------------------------------

class SDRPlayLib:
    STREAM_CALLBACK = ctypes.CFUNCTYPE(
        None, ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p)
    GAIN_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_uint, ctypes.c_uint,
                                     ctypes.c_void_p)
    # mir_sdr_ReasonForReinitT flags
    CHANGE_GR = 0x01
    CHANGE_FS_FREQ = 0x02
    CHANGE_RF_FREQ = 0x04
    CHANGE_BW_TYPE = 0x08
    CHANGE_IF_TYPE = 0x10
    IF_ZERO = 0
    LO_UNDEFINED = 0

    def __init__(self):
        self.lib = _load("mirsdrapi-rsp", "sdrplay_api")
        self._stream_cb = None
        self._gain_cb = None
        self._sink = None
        self.gain_reduction = 40
        self.sample_rate = 2e6
        self.frequency = 433.92e6
        self.bandwidth_khz = 1536
        self.lna_state = 0
        self.running = False
        if self.lib is not None:
            self.lib.mir_sdr_StreamInit.argtypes = [
                ctypes.POINTER(ctypes.c_int), ctypes.c_double, ctypes.c_double,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), self.STREAM_CALLBACK,
                self.GAIN_CALLBACK, ctypes.c_void_p]
            self.lib.mir_sdr_Reinit.argtypes = [
                ctypes.POINTER(ctypes.c_int), ctypes.c_double, ctypes.c_double,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int]

    @property
    def available(self):
        return self.lib is not None

    def setup(self, device_identifier=None):
        return True  # device selection happens in StreamInit

    def close(self):
        self.stop_rx()

    def _reinit(self, reason):
        if not self.running:
            return 0
        gr = ctypes.c_int(int(self.gain_reduction))
        gr_system = ctypes.c_int(0)
        spp = ctypes.c_int(0)
        return self.lib.mir_sdr_Reinit(
            ctypes.byref(gr), self.sample_rate / 1e6, self.frequency / 1e6,
            self.bandwidth_khz, self.IF_ZERO, self.LO_UNDEFINED,
            self.lna_state, ctypes.byref(gr_system), 0, ctypes.byref(spp), reason)

    def set_center_freq(self, freq):
        self.frequency = float(freq)
        return self._reinit(self.CHANGE_RF_FREQ)

    def set_sample_rate(self, rate):
        self.sample_rate = float(rate)
        return self._reinit(self.CHANGE_FS_FREQ)

    def set_bandwidth(self, bw):
        self.bandwidth_khz = int(bw / 1e3)
        return self._reinit(self.CHANGE_BW_TYPE)

    def set_gain(self, gain):
        self.gain_reduction = int(gain)
        return self._reinit(self.CHANGE_GR)

    def set_if_gain(self, gain):
        return self.set_gain(gain)

    def set_antenna(self, index):
        if hasattr(self.lib, "mir_sdr_RSPII_AntennaControl"):
            return self.lib.mir_sdr_RSPII_AntennaControl(5 + int(bool(index)))
        return 0

    def start_rx(self, sink):
        self._sink = sink

        def stream_cb(xi, xq, first_sample, gr_changed, rf_changed, fs_changed,
                      num_samples, reset, hw_removed, ctx):
            n = int(num_samples)
            iq = np.empty(2 * n, dtype=np.int16)
            iq[0::2] = np.ctypeslib.as_array(xi, shape=(n,))
            iq[1::2] = np.ctypeslib.as_array(xq, shape=(n,))
            try:
                self._sink(iq.tobytes())
            except (BrokenPipeError, OSError) as e:
                logger.warning("SDRPlay RX: " + str(e))

        def gain_cb(gain_reduction, lna_gain_reduction, ctx):
            pass

        self._stream_cb = self.STREAM_CALLBACK(stream_cb)
        self._gain_cb = self.GAIN_CALLBACK(gain_cb)
        gr = ctypes.c_int(int(self.gain_reduction))
        gr_system = ctypes.c_int(0)
        spp = ctypes.c_int(0)
        ret = self.lib.mir_sdr_StreamInit(
            ctypes.byref(gr), self.sample_rate / 1e6, self.frequency / 1e6,
            self.bandwidth_khz, self.IF_ZERO, self.lna_state,
            ctypes.byref(gr_system), 0, ctypes.byref(spp),
            self._stream_cb, self._gain_cb, None)
        self.running = ret == 0
        return ret

    def stop_rx(self):
        if self.running and self.lib is not None:
            self.lib.mir_sdr_StreamUninit()
            self.running = False
