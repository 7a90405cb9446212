"""The hardware backends against urh_tpu's, on the CPU: the Device runtime,
RTL-TCP, the vendor bindings, the native device classes, VirtualDevice's
native backend and the GNU Radio bridge.

The same bytes, commands and captures go through both packages.  The one
live path is a ProtocolSniffer over RTL-TCP in each package, each against
its own loopback fake rtl_tcp server streaming the same seeded int8 FSK
capture: each package's spawned RTLSDRTCP child connects, programs the
server, and pipes the bytes into the int8 receive buffer, which the
sniffer's stream demodulates (the port's on ``compute_device="cpu"``).
The two children are spawned at once, once in this file (each pays its
package's import).  No wait is a bare sleep: each polls a condition under
a deadline.
"""

import ctypes
import json
import os
import shutil
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

import test_gr_scripts as gr_fakes
import test_vendor_bindings_fakelib as vendor_fakes
from urh_tpu.dev import device as jax_device
from urh_tpu.dev import native_devices as jax_nd
from urh_tpu.dev import rtl_tcp as jax_rtl_tcp
from urh_tpu.dev import vendor_libs as jax_vendor
from urh_tpu.dev.backend_handler import BackendHandler as JaxBackendHandler
from urh_tpu.dev.gr import base_thread as jax_base_thread
from urh_tpu.dev.gr import generate_scripts as jax_generate
from urh_tpu.dev.virtual_device import Mode as JaxMode
from urh_tpu.dev.virtual_device import VirtualDevice as JaxVirtualDevice
from urh_tpu.protocol.sniffer import ProtocolSniffer as JaxSniffer
from urh_tpu.util import settings as jax_settings
from urh_tpu_torch.dev import device
from urh_tpu_torch.dev import native_devices as nd
from urh_tpu_torch.dev import rtl_tcp
from urh_tpu_torch.dev import vendor_libs
from urh_tpu_torch.dev.backend_handler import BackendHandler
from urh_tpu_torch.dev.gr import base_thread
from urh_tpu_torch.dev.gr import device_table
from urh_tpu_torch.dev.gr import generate_scripts
from urh_tpu_torch.dev.virtual_device import Mode, VirtualDevice
from urh_tpu_torch.protocol.sniffer import ProtocolSniffer
from urh_tpu_torch.util import settings

torch.set_num_threads(1)

DEADLINE_S = 60.0  # each spawned child imports its package (torch, JAX) first
PACKAGES = (("urh_tpu", jax_rtl_tcp), ("urh_tpu_torch", rtl_tcp))


def _wait(condition, what: str, deadline_s: float = DEADLINE_S):
    deadline = time.monotonic() + deadline_s
    while not condition():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} not reached within {deadline_s} s")
        time.sleep(0.005)


# -- RTL-TCP: codec, registry, link ---------------------------------------------------


@pytest.mark.parametrize("opcode,value", [(0x01, 433_920_000), (0x04, 0), (0x05, -42),
                                          (0x02, 2**32 - 1), (0x40, 2**32 + 5), (0x1FF, 7)])
def test_encode_command_equals_urh_tpu(opcode, value):
    assert rtl_tcp.encode_command(opcode, value) == jax_rtl_tcp.encode_command(opcode, value)


@pytest.mark.parametrize("blob", [b"RTL0" + (5).to_bytes(4, "big") + (29).to_bytes(4, "big"),
                                  b"RTL0" + (99).to_bytes(4, "big") + bytes(4),
                                  b"RTL0short", b"HTTP/1.1 400\r\n", b"NOPE" + bytes(8)])
def test_parse_greeting_equals_urh_tpu(blob):
    assert rtl_tcp.parse_greeting(blob) == jax_rtl_tcp.parse_greeting(blob)


def test_registry_equals_urh_tpu():
    fields = lambda params: [(p.name, p.opcode, p.command, p.startup) for p in params]
    assert fields(rtl_tcp.PARAMETERS) == fields(jax_rtl_tcp.PARAMETERS)
    assert sorted(rtl_tcp._BY_COMMAND) == sorted(jax_rtl_tcp._BY_COMMAND)
    assert [p.name for p in rtl_tcp.PARAMETERS if p.startup][-1] == "tunerGain"


def test_bytes_to_iq_over_every_byte_pair_equals_urh_tpu():
    pairs = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"),
                     -1).astype(np.uint8).tobytes()
    got = rtl_tcp.RTLSDRTCP.bytes_to_iq(pairs + b"\x07")  # a split pair's byte dropped
    want = jax_rtl_tcp.RTLSDRTCP.bytes_to_iq(pairs + b"\x07")
    assert got.dtype == want.dtype == np.int8 and got.shape == (65536, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.astype(np.int16) + 128,
                                  np.frombuffer(pairs, np.uint8).reshape(-1, 2))


class FakeRtlTcpServer:
    """rtl_tcp on a loopback socket (tests/test_rtl_tcp.py's): the RTL0
    greeting, then every 5-byte command it receives recorded, and whatever
    ``send`` is given streamed to the client."""

    def __init__(self, tuner_type=5, gain_count=29):
        self.greeting = b"RTL0" + tuner_type.to_bytes(4, "big") + gain_count.to_bytes(4, "big")
        self.commands = []
        self.connected = threading.Event()
        self.conn = None
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        try:
            self.conn, _ = self._srv.accept()
        except OSError:
            return
        self.conn.sendall(self.greeting)
        self.connected.set()
        buf = b""
        while True:
            try:
                chunk = self.conn.recv(4096)
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            while len(buf) >= 5:
                self.commands.append((buf[0], int.from_bytes(buf[1:5], "big")))
                buf = buf[5:]

    def send(self, data: bytes):
        assert self.connected.wait(DEADLINE_S), "no client connected"
        self.conn.sendall(data)

    def close(self):
        for s in (self.conn, self._srv):
            if s is not None:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                s.close()


def test_link_sends_the_same_commands_as_urh_tpu():
    config = {"frequency": 433_920_000, "sample_rate": 2_000_000, "bandwidth": 1_000_000,
              "gain": 300, "freq_correction": -3, "direct_sampling_mode": 2,
              "bias_tee_enabled": 1}
    sent = {}
    for name, pkg in PACKAGES:
        server = FakeRtlTcpServer(tuner_type=6, gain_count=7)
        link = pkg.RtlTcpLink("127.0.0.1", server.port)
        greeting = link.connect()
        link.program(config)
        link.set("agcMode", 1)
        server.send(bytes(range(16)))
        data = b""
        deadline = time.monotonic() + DEADLINE_S
        while len(data) < 16 and time.monotonic() < deadline:
            data += link.read()
        link.close()
        _wait(lambda: len(server.commands) == 8, f"{name}: the commands recorded")
        sent[name] = (greeting, server.commands, data)
        server.close()
    assert sent["urh_tpu_torch"] == sent["urh_tpu"]
    greeting, commands, data = sent["urh_tpu"]
    assert greeting == {"tuner": "R828D", "gain_count": 7} and data == bytes(range(16))
    assert [c[0] for c in commands] == [0x01, 0x02, 0x05, 0x09, 0x0E, 0x40, 0x04, 0x08]


def test_receive_sync_dispatches_like_urh_tpu():
    """The child's entry point on a thread: its control messages and the
    commands a runtime retune and an unsupported command send."""
    out = {}
    for name, pkg in PACKAGES:
        server = FakeRtlTcpServer()
        data_rx, data_tx = device._mp.Pipe(duplex=False)
        ctrl_a, ctrl_b = device._mp.Pipe()
        t = threading.Thread(target=pkg.RTLSDRTCP.receive_sync, daemon=True, args=(
            data_tx, ctrl_b, {"frequency": 100_000_000, "sample_rate": 1_000_000, "gain": 200},
            "127.0.0.1", server.port))
        t.start()
        assert ctrl_a.poll(DEADLINE_S)
        hello = ctrl_a.recv()
        ctrl_a.send(("SET_FREQUENCY", 868_000_000))
        ctrl_a.send(("SET_BB_GAIN", 5))  # no rtl_tcp parameter: logged, not sent
        _wait(lambda: len(server.commands) == 4, f"{name}: the retune recorded")
        ctrl_a.send("STOP")
        t.join(DEADLINE_S)
        assert not t.is_alive()
        out[name] = (hello.replace(str(server.port), "PORT"), ctrl_a.recv(),
                     list(server.commands))
        server.close()
    assert out["urh_tpu_torch"] == out["urh_tpu"]
    assert out["urh_tpu"][1] == "close:0"


# -- C6: RTL-TCP ignores the port number it is given (urh_tpu's own) -----------------


@pytest.mark.parametrize("pkg", ["urh_tpu", "urh_tpu_torch"])
def test_rtl_tcp_keeps_port_1234_whatever_port_it_is_given(pkg):
    """VirtualDevice takes ``portnumber`` and hands it to
    _create_native_device, whose RTL-TCP branch never passes it on:
    RTLSDRTCP connects to 1234 until its ``port`` is set.  The port keeps
    urh_tpu's behaviour (ROADMAP C6)."""
    vd_cls, handler, mode = ((JaxVirtualDevice, JaxBackendHandler, JaxMode) if pkg == "urh_tpu"
                             else (VirtualDevice, BackendHandler, Mode))
    vd = vd_cls(handler(), "RTL-TCP", mode.receive, portnumber=5555)
    assert type(vd._dev).__name__ == "RTLSDRTCP"
    assert vd._dev.port == 1234
    assert vd._dev.receive_process_arguments[3:] == ("127.0.0.1", 1234)
    vd._dev.port = 5555
    assert vd._dev.receive_process_arguments[3:] == ("127.0.0.1", 5555)


# -- a sniffer over RTL-TCP in each package ---------------------------------------------

SPS, N_MSGS, N_BITS, PAUSE = 20, 12, 64, 1200
GATE = 10 * SPS  # the stream's pause gate: 10 symbols


def _int8_fsk(seed=23):
    """N_MSGS messages of N_BITS random bits, continuous-phase FSK at +-25
    kHz of 1 Msps, SPS samples a bit, a PAUSE-sample pause before each,
    amplitude 0.75 and noise sigma 0.01, as int8 -> (capture, bits)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (N_MSGS, N_BITS), dtype=np.uint8)
    sym = np.concatenate([np.concatenate((np.full(PAUSE, -1), np.repeat(b, SPS)))
                          for b in bits])
    phase = np.cumsum(np.where(sym == 1, 1.0, -1.0) * (2 * np.pi * 25e3 / 1e6))
    iq = 0.75 * (sym >= 0)[:, None] * np.stack((np.cos(phase), np.sin(phase)), -1)
    iq += rng.normal(0, 0.01, iq.shape)
    return np.clip(np.round(iq * 127), -128, 127).astype(np.int8), bits


def _sniffer(cls, handler, port: int, **kwargs):
    # the stream's noise threshold is in normalized units for every sample type
    sniffer = cls(SPS, 0.0, 0.1, 0.15, 5, "FSK", 1, "RTL-TCP", handler(), **kwargs)
    sniffer.rcv_device._dev.port = port  # C6: the device keeps 1234 otherwise
    fed = []
    ingest = sniffer._ingest

    def counted(chunk):
        ingest(chunk)
        fed.append(len(chunk))

    sniffer._ingest = counted
    return sniffer, fed


def test_sniffer_over_rtl_tcp_equals_urh_tpu(monkeypatch):
    monkeypatch.setattr(jax_settings, "OVERWRITE_RECEIVE_BUFFER_SIZE", 100_000)
    monkeypatch.setattr(settings, "OVERWRITE_RECEIVE_BUFFER_SIZE", 100_000)
    capture, bits = _int8_fsk()
    wire = (capture.astype(np.int16) + 128).astype(np.uint8)
    silence = np.full((2 * GATE, 2), 128, np.uint8)
    servers = {name: FakeRtlTcpServer() for name, _ in PACKAGES}
    sniffers = {
        "urh_tpu": _sniffer(JaxSniffer, JaxBackendHandler, servers["urh_tpu"].port),
        "urh_tpu_torch": _sniffer(ProtocolSniffer, BackendHandler, servers["urh_tpu_torch"].port,
                                  compute_device="cpu")}
    try:
        for sniffer, _ in sniffers.values():
            assert sniffer.rcv_device.data_type == np.int8
            sniffer.sniff()
        for name, (sniffer, fed) in sniffers.items():
            _wait(lambda: any("Connected to rtl_tcp" in m
                              for m in sniffer.rcv_device._dev.device_messages),
                  f"{name}: the child connected")
            _wait(lambda: len(servers[name].commands) == 7, f"{name}: the startup commands")
            servers[name].send(wire.tobytes() + silence.tobytes())
        total = len(wire) + len(silence)
        for name, (sniffer, fed) in sniffers.items():
            _wait(lambda: sniffer.rcv_device.current_index == total and sum(fed) == total,
                  f"{name}: {total} samples received and fed")
            servers[name].send(silence[:GATE].tobytes())  # a continuing stream's next gate
            _wait(lambda: sum(fed) == total + GATE, f"{name}: the last gate fed")
        for sniffer, _ in sniffers.values():
            sniffer.stop()
    finally:
        for server in servers.values():
            server.close()
    got = {name: [(m.plain_bits_str, m.pause) for m in s.messages]
           for name, (s, _) in sniffers.items()}
    assert got["urh_tpu_torch"] == got["urh_tpu"]
    assert [b for b, _ in got["urh_tpu_torch"]] == ["".join(map(str, b)) for b in bits]
    assert servers["urh_tpu_torch"].commands == servers["urh_tpu"].commands
    # stop() joined each child; the port's (Device.JOIN_TIMEOUT) exited on its own
    assert sniffers["urh_tpu"][0].rcv_device._dev.receive_process.exitcode is not None
    assert sniffers["urh_tpu_torch"][0].rcv_device._dev.receive_process.exitcode == 0


# -- VirtualDevice's native backend ----------------------------------------------------

NAMES = list(BackendHandler.DEVICE_NAMES) + ["Rad1o", "Unknown SDR"]


@pytest.mark.parametrize("name", NAMES)
def test_virtual_device_builds_the_same_native_device(name):
    """In testing mode every name selects the native backend: both packages
    build the same device class, or raise the same error."""
    def build(vd_cls, handler, mode):
        try:
            vd = vd_cls(handler(testing_mode=True), name, mode.receive)
        except ValueError as e:
            return "ValueError", str(e)
        return vd.backend.name, type(vd._dev).__name__ if vd._dev is not None else None

    want = build(JaxVirtualDevice, JaxBackendHandler, JaxMode)
    assert build(VirtualDevice, BackendHandler, Mode) == want
    if name in ("FUNcube", "Unknown SDR"):
        assert want[0] in ("ValueError", "none"), want


# -- the native device classes --------------------------------------------------------

CLASSES = ["HackRF", "Rad1o", "RTLSDR", "USRP", "LimeSDR", "BladeRF", "PlutoSDR", "AirSpy",
           "SDRPlay", "SoundCard"]


@pytest.mark.parametrize("cls_name", CLASSES)
def test_native_device_class_equals_urh_tpu(cls_name):
    got, want = getattr(nd, cls_name), getattr(jax_nd, cls_name)
    assert got.DATA_TYPE == want.DATA_TYPE
    assert got.DEVICE_METHODS == want.DEVICE_METHODS
    assert (got.ASYNCHRONOUS, got.SYNC_TX_CHUNK_SIZE, got.CONTINUOUS_TX_CHUNK_SIZE) == \
        (want.ASYNCHRONOUS, want.SYNC_TX_CHUNK_SIZE, want.CONTINUOUS_TX_CHUNK_SIZE)
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    if np.dtype(want.DATA_TYPE) == np.float32:
        raw = rng.uniform(-1, 1, 1024).astype(np.float32).tobytes()
    np.testing.assert_array_equal(got.bytes_to_iq(raw), want.bytes_to_iq(raw))
    samples = rng.uniform(-1, 1, (300, 2)).astype(np.float32)
    if np.dtype(want.DATA_TYPE) != np.float32:
        samples = np.round(samples * 100).astype(want.DATA_TYPE)
    assert bytes(got.iq_to_bytes(samples)) == bytes(want.iq_to_bytes(samples))


def test_setup_without_a_library_reports_like_urh_tpu():
    class Conn:
        def __init__(self):
            self.messages = []

        def send(self, msg):
            self.messages.append(msg)

    for cls_name in ("USRP", "LimeSDR", "BladeRF", "PlutoSDR", "AirSpy", "SDRPlay"):
        got, want = getattr(nd, cls_name), getattr(jax_nd, cls_name)
        if want.DEVICE_LIB is not None or got.DEVICE_LIB is not None:
            continue  # a vendor library is installed here
        a, b = Conn(), Conn()
        assert got.setup_device(a, None) is want.setup_device(b, None) is False
        assert a.messages == b.messages and len(a.messages) == 1


def test_device_base_equals_urh_tpu():
    assert [c.name for c in device.Device.Command] == [c.name for c in jax_device.Device.Command]
    assert device.Device.DEVICE_METHODS == jax_device.Device.DEVICE_METHODS
    assert device.Device.FORWARDED_PARAMS == jax_device.Device.FORWARDED_PARAMS
    assert device._mp.get_start_method() == "spawn"
    # deliberate: a child that imported torch may take over urh_tpu's 1 s to exit
    assert (device.Device.JOIN_TIMEOUT, jax_device.Device.JOIN_TIMEOUT) == (10.0, 1.0)
    # a send config walks the same cursor: 20 values twice, 6 at a time
    walks = []
    for cfg_cls, dev_cls in ((device.SendConfig, device.Device),
                             (jax_device.SendConfig, jax_device.Device)):
        buffer = dev_cls.iq_to_bytes(np.arange(20, dtype=np.float32).reshape(-1, 2))
        index, repeat = device._mp.Value("L", 0), device._mp.Value("L", 0)
        cfg = cfg_cls(buffer, index, repeat, 20, 2)
        chunks = []
        while not cfg.sending_is_finished() and len(chunks) < 20:
            chunks.append(cfg.get_data_to_send(6).tolist())
        walks.append(chunks)
    assert walks[0] == walks[1] and len(walks[0]) == 8


# -- the vendor bindings against fake C libraries ----------------------------------------

needs_gcc = pytest.mark.skipif(shutil.which("gcc") is None, reason="gcc not available")


def _airspy(v, so):
    lib = v.AirSpyLib()
    lib.lib = ctypes.CDLL(so)
    received = []
    out = (lib.setup(), lib.set_center_freq(433.92e6), lib.set_center_freq(100e6) != 0,
           lib.start_rx(received.append))
    lib.stop_rx()
    lib.close()
    return out + (np.frombuffer(received[0], np.float32).tolist(),)


def _limesdr(v, so):
    lib = v.LimeSDRLib.__new__(v.LimeSDRLib)
    lib.lib = ctypes.CDLL(so)
    lib.dev, lib.stream, lib.is_tx, lib.channel = ctypes.c_void_p(), v.LmsStream(), False, 0
    for fn, args in (("LMS_SetLOFrequency", [ctypes.c_void_p, ctypes.c_bool, ctypes.c_size_t,
                                             ctypes.c_double]),
                     ("LMS_SetSampleRate", [ctypes.c_void_p, ctypes.c_double, ctypes.c_size_t]),
                     ("LMS_SetNormalizedGain", [ctypes.c_void_p, ctypes.c_bool,
                                                ctypes.c_size_t, ctypes.c_double]),
                     ("LMS_SetLPFBW", [ctypes.c_void_p, ctypes.c_bool, ctypes.c_size_t,
                                       ctypes.c_double])):
        getattr(lib.lib, fn).argtypes = args
    out = (lib.setup("1A2B"), lib.set_center_freq(433.92e6), lib.set_normalized_gain(0.5),
           lib.set_normalized_gain(5) != 0, lib.setup_stream(),
           np.frombuffer(lib.receive_sync(), np.float32).tolist())
    lib.stop_stream()
    lib.close()
    return out


def _bladerf(v, so):
    lib = v.BladeRFLib.__new__(v.BladeRFLib)
    lib.lib = ctypes.CDLL(so)
    lib.dev, lib.is_tx = ctypes.c_void_p(), False
    lib.lib.bladerf_open.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p]
    lib.lib.bladerf_set_frequency.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64]
    out = (lib.setup(), lib.set_center_freq(5.8e9), lib.set_center_freq(433.92e6) != 0,
           lib.set_sample_rate(2e6), np.frombuffer(lib.receive_sync(), np.int16)[:8].tolist())
    lib.close()
    return out


def _usrp(v, so):
    lib = v.USRPLib.__new__(v.USRPLib)
    lib.lib = ctypes.CDLL(so)
    lib.handle, lib.rx_streamer, lib.rx_metadata = (ctypes.c_void_p(), ctypes.c_void_p(),
                                                    ctypes.c_void_p())
    lib.channel = ctypes.c_size_t(0)
    lib.lib.uhd_usrp_set_rx_rate.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_size_t]
    lib.lib.uhd_usrp_set_rx_gain.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_size_t,
                                             ctypes.c_char_p]
    lib.lib.uhd_usrp_set_rx_bandwidth.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                                  ctypes.c_size_t]
    lib.lib.uhd_rx_streamer_recv.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_double, ctypes.c_bool,
        ctypes.POINTER(ctypes.c_size_t)]
    out = (lib.setup(""), lib.set_center_freq(433.92e6), lib.set_sample_rate(2e6),
           lib.start_stream(), np.frombuffer(lib.receive_sync(), np.float32).tolist())
    lib.stop_stream()
    lib.close()
    return out


def _plutosdr(v, so):
    lib = v.PlutoSDRLib.__new__(v.PlutoSDRLib)
    lib.lib = ctypes.CDLL(so)
    lib.ctx = lib.phy = lib.rx_dev = lib.buffer = None
    lib.rx_channels = []
    c = ctypes
    protos = {
        "iio_create_context_from_uri": (c.c_void_p, [c.c_char_p]),
        "iio_create_default_context": (c.c_void_p, None),
        "iio_context_find_device": (c.c_void_p, [c.c_void_p, c.c_char_p]),
        "iio_device_find_channel": (c.c_void_p, [c.c_void_p, c.c_char_p, c.c_bool]),
        "iio_channel_attr_write_longlong": (None, [c.c_void_p, c.c_char_p, c.c_longlong]),
        "iio_channel_attr_write": (None, [c.c_void_p, c.c_char_p, c.c_char_p]),
        "iio_device_create_buffer": (c.c_void_p, [c.c_void_p, c.c_size_t, c.c_bool]),
        "iio_buffer_first": (c.c_void_p, [c.c_void_p, c.c_void_p]),
        "iio_channel_enable": (None, [c.c_void_p]),
        "iio_buffer_refill": (c.c_ssize_t, [c.c_void_p]),
        "iio_buffer_destroy": (None, [c.c_void_p]),
        "iio_context_destroy": (None, [c.c_void_p]),
        "fake_last_attr": (c.c_char_p, None), "fake_last_value": (c.c_longlong, None)}
    for fn, (restype, argtypes) in protos.items():
        if restype is not None:
            getattr(lib.lib, fn).restype = restype
        if argtypes is not None:
            getattr(lib.lib, fn).argtypes = argtypes
    out = (lib.setup("ip:192.168.2.1"), lib.set_center_freq(2.4e9), lib.lib.fake_last_attr(),
           lib.lib.fake_last_value(), lib.set_sample_rate(61_440_000),
           lib.lib.fake_last_attr(), np.frombuffer(lib.receive_sync(), np.int16)[:8].tolist())
    lib.close()
    return out


BINDINGS = {"airspy": (_airspy, "AIRSPY_C"), "limesdr": (_limesdr, "LIME_C"),
            "bladerf": (_bladerf, "BLADERF_C"), "usrp": (_usrp, "UHD_C"),
            "plutosdr": (_plutosdr, "PLUTO_C")}


@needs_gcc
@pytest.mark.parametrize("name", sorted(BINDINGS))
def test_vendor_binding_against_a_fake_library_equals_urh_tpu(tmp_path, name):
    """tests/test_vendor_bindings_fakelib.py's fake C libraries, compiled by
    gcc, driven through both packages' bindings: every return value and
    sample equal."""
    drive, source = BINDINGS[name]
    so = vendor_fakes.build(tmp_path, name + "fake", getattr(vendor_fakes, source))
    want = drive(jax_vendor, so)
    assert drive(vendor_libs, so) == want
    assert want[0] and all(x == 0 or x is True for x in want[1:3] if not isinstance(x, bytes))


# -- the GNU Radio bridge ---------------------------------------------------------------


def _script_pairs():
    for device in device_table.GR_DEVICES:
        for direction in device.directions:
            yield device, direction


@pytest.mark.parametrize("device,direction", list(_script_pairs()),
                         ids=lambda x: getattr(x, "script_stem", x))
def test_generated_script_equals_urh_tpu_but_its_generator_line(device, direction):
    got = generate_scripts._render(device, direction).split("\n")
    want = jax_generate._render(device, direction).split("\n")
    assert got[1] == want[1].replace("urh_tpu.dev.gr", "urh_tpu_torch.dev.gr")
    assert got[:1] + got[2:] == want[:1] + want[2:]


def test_checked_in_scripts_are_the_generators_and_urh_tpus(tmp_path):
    written = generate_scripts.generate(str(tmp_path))
    names = sorted(os.listdir(generate_scripts.SCRIPTS_DIR))
    assert names == sorted(os.listdir(jax_generate.SCRIPTS_DIR))
    assert len(names) == 12 and len(written) == 10
    for name in names:
        with open(os.path.join(generate_scripts.SCRIPTS_DIR, name), "rb") as f:
            ours = f.read()
        with open(os.path.join(jax_generate.SCRIPTS_DIR, name), "rb") as f:
            theirs = f.read()
        if os.path.exists(tmp_path / name):
            assert (tmp_path / name).read_bytes() == ours
            ours_lines, theirs_lines = ours.split(b"\n"), theirs.split(b"\n")
            assert ours_lines[:1] + ours_lines[2:] == theirs_lines[:1] + theirs_lines[2:]
        else:  # the hand-written templates
            assert ours == theirs


def _fake_env(tmp_path, monkeypatch):
    """tests/test_gr_scripts.py's fake gnuradio and osmosdr, journaling each
    osmosdr call, in this process's environment (the bridge's Popen
    inherits it)."""
    fakes = tmp_path / "fakes"
    (fakes / "gnuradio").mkdir(parents=True)
    (fakes / "osmosdr.py").write_text(gr_fakes.FAKE_OSMOSDR)
    (fakes / "gnuradio" / "__init__.py").write_text(gr_fakes.FAKE_GNURADIO)
    log = tmp_path / "calls.jsonl"
    monkeypatch.setenv("PYTHONPATH", str(fakes))
    monkeypatch.setenv("FAKE_GR_LOG", str(log))
    monkeypatch.setenv("FAKE_GR_RUN_SECS", "30")
    return log


def _journal(log, want: int):
    _wait(lambda: log.exists() and len(log.read_text().splitlines()) >= want,
          f"{want} osmosdr calls")
    return [json.loads(line) for line in log.read_text().splitlines()]


def _receive_through_bridge(module, tmp_path, monkeypatch, payload: bytes):
    """A ReceiverThread of ``module`` for a HackRF whose flowgraph runs under
    the fakes: the osmosdr calls of its start and of two retunes on stdin,
    and the samples it reads from a TCP server standing for the
    flowgraph's sink (which closes once the retunes are journaled)."""
    log = _fake_env(tmp_path, monkeypatch)
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    thread = module.ReceiverThread(433.92e6, 2e6, 1.75e6, 30, 24, 18)
    thread.gr_python_interpreter = sys.executable
    thread.gr_port = srv.getsockname()[1]
    thread.device = "HackRF"
    release = threading.Event()

    def serve():
        conn, _ = srv.accept()
        conn.sendall(payload)
        release.wait(DEADLINE_S)
        conn.close()

    server = threading.Thread(target=serve, daemon=True)
    server.start()
    thread.start()
    _journal(log, 7)  # source, rate, frequency, gain, IF and BB gain, bandwidth
    _wait(lambda: thread.current_index == len(payload) // 8, "the samples received")
    thread.frequency = 868e6
    thread.if_gain = 12
    calls = _journal(log, 9)
    release.set()
    thread.join(DEADLINE_S)
    server.join(DEADLINE_S)
    srv.close()
    assert not thread.is_alive() and thread.gr_process is None
    return calls, np.array(thread.data[:thread.current_index])


@pytest.mark.parametrize("direction", ["recv", "send"])
def test_bridge_command_lines_equal_urh_tpu(direction, monkeypatch):
    monkeypatch.setattr(settings, "_store", {"gr_python_interpreter": "/usr/bin/python3"})
    monkeypatch.setattr(jax_settings, "_store", {"gr_python_interpreter": "/usr/bin/python3"})
    lines = []
    for module in (jax_base_thread, base_thread):
        cls = module.ReceiverThread if direction == "recv" else module.SenderThread
        thread = cls(433.92e6, 2e6, 1.75e6, 30, 24, 18)
        thread.device = "HackRF"
        with pytest.MonkeyPatch.context() as mp:
            started = {}
            mp.setattr(module, "Popen", lambda options, **kw: started.setdefault("argv", options))
            thread.init_process()
        assert thread.gr_python_interpreter == "/usr/bin/python3"
        argv = started["argv"]
        lines.append([argv[0], os.path.basename(argv[1])] + argv[2:])
    assert lines[1] == lines[0]


def test_receiver_bridge_equals_urh_tpu(tmp_path, monkeypatch):
    payload = np.random.default_rng(9).uniform(-1, 1, (5000, 2)).astype(np.float32).tobytes()
    monkeypatch.setattr(jax_settings, "OVERWRITE_RECEIVE_BUFFER_SIZE", 20_000)
    monkeypatch.setattr(settings, "OVERWRITE_RECEIVE_BUFFER_SIZE", 20_000)
    got = _receive_through_bridge(base_thread, tmp_path / "port", monkeypatch, payload + b"\x01")
    want = _receive_through_bridge(jax_base_thread, tmp_path / "jax", monkeypatch,
                                   payload + b"\x01")
    assert got[0] == want[0]  # the flowgraph's osmosdr calls, retunes included
    assert got[0][-2:] == [{"call": "set_center_freq", "value": [868000000.0, 0]},
                           {"call": "set_if_gain", "value": [12.0, 0]}]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1], np.frombuffer(payload, np.float32).reshape(-1, 2))


def _send_through_bridge(module, tmp_path, monkeypatch, samples: np.ndarray):
    """A SenderThread of ``module`` for a USRP whose flowgraph runs under the
    fakes; this test connects where the flowgraph's TCP source would and
    reads what the thread streams until it closes."""
    _fake_env(tmp_path, monkeypatch)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    thread = module.SenderThread(433.92e6, 2e6, 1e6, 30, 0, 0)
    thread.gr_python_interpreter = sys.executable
    thread.gr_port = port
    thread.device = "USRP"
    thread.samples_per_transmission = 1000
    thread.data = samples
    thread.start()
    conn = None

    def connected():
        nonlocal conn
        try:
            conn = socket.create_connection(("127.0.0.1", port), timeout=DEADLINE_S)
        except OSError:
            return False
        return True

    _wait(connected, "the sender's server")
    received = b""
    while True:
        chunk = conn.recv(1 << 16)
        if not chunk:
            break
        received += chunk
    conn.close()
    thread.join(DEADLINE_S)
    assert not thread.is_alive() and thread.gr_process is None
    return received, thread.current_index


def test_sender_bridge_equals_urh_tpu(tmp_path, monkeypatch):
    samples = np.random.default_rng(10).uniform(-1, 1, (4321, 2)).astype(np.float32)
    got = _send_through_bridge(base_thread, tmp_path / "port", monkeypatch, samples)
    want = _send_through_bridge(jax_base_thread, tmp_path / "jax", monkeypatch, samples)
    assert got == want
    assert got == (samples.tobytes(), len(samples))
