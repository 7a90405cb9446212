"""The live loop (Network SDR, ProtocolSniffer, TX by GeneratorBackend and
ContinuousModulator) against urh_tpu's, on the CPU.

The same seeded captures and byte streams go through both packages.  The
port runs with ``compute_device="cpu"`` / ``device="cpu"``, where its
kernels' plain versions run; urh_tpu runs its XLA programs on the CPU.
Messages (bits and pauses) must be equal, PSK's too (the two Costas loops
stay within about 2e-6 of each other, and the pulse machine's tolerance
absorbs that, tests/test_torch_costas.py).  TX samples are held to
tests/test_torch_modulate.py's tolerances: float32 within FLOAT_ULPS ulps
of the amplitude.

Nothing here orders two steps by sleeping alone: every wait polls a
condition under a deadline (``_wait``).
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from urh_tpu.core.iq import IQData as JaxIQData
from urh_tpu.dev import network_sdr as jax_network_sdr
from urh_tpu.dev.backend_handler import BackendHandler as JaxBackendHandler
from urh_tpu.dev.config import DEVICE_CONFIG as JAX_DEVICE_CONFIG
from urh_tpu.dsp import continuous_modulator as jax_cm
from urh_tpu.dsp.modulate import modulate
from urh_tpu.dsp.modulator import Modulator as JaxModulator
from urh_tpu.protocol.container import ProtocolAnalyzerContainer as JaxContainer
from urh_tpu.protocol.generator import GeneratorBackend as JaxGenerator
from urh_tpu.protocol.message import Message as JaxMessage
from urh_tpu.protocol.sniffer import ProtocolSniffer as JaxSniffer
from urh_tpu.util import metrics as jax_metrics
from urh_tpu.util import settings as jax_settings
from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.dev import network_sdr
from urh_tpu_torch.dev.backend_handler import BackendHandler
from urh_tpu_torch.dev.config import DEVICE_CONFIG
from urh_tpu_torch.dev.endless_sender import EndlessSender
from urh_tpu_torch.dev.virtual_device import Mode, VirtualDevice
from urh_tpu_torch.dsp import continuous_modulator as cm
from urh_tpu_torch.dsp.modulator import Modulator
from urh_tpu_torch.protocol import sniffer as sniffer_module
from urh_tpu_torch.protocol.container import ProtocolAnalyzerContainer
from urh_tpu_torch.protocol.generator import GeneratorBackend
from urh_tpu_torch.protocol.message import Message
from urh_tpu_torch.protocol.sniffer import ProtocolSniffer
from urh_tpu_torch.protocol.stream import PAUSE_GATE_SYMBOLS
from urh_tpu_torch.util import metrics
from urh_tpu_torch.util import settings
from urh_tpu_torch.util.events import Event

torch.set_num_threads(1)

NETWORK_SDR = "Network SDR"
DEADLINE_S = 20.0
SPAWN_DEADLINE_S = 60.0
FLOAT_ULPS = 4  # tests/test_torch_modulate.py
BUFFER = 200_000  # receive buffer of the sniffer tests, in samples


def _wait(condition, deadline_s=DEADLINE_S, what="condition"):
    """Poll ``condition`` until it holds; fail after ``deadline_s``."""
    deadline = time.monotonic() + deadline_s
    while not condition():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} not reached within {deadline_s} s")
        time.sleep(0.005)


@pytest.fixture
def receive_buffer(monkeypatch):
    """Both packages' receive buffers at BUFFER samples."""
    monkeypatch.setattr(jax_settings, "OVERWRITE_RECEIVE_BUFFER_SIZE", BUFFER)
    monkeypatch.setattr(settings, "OVERWRITE_RECEIVE_BUFFER_SIZE", BUFFER)


# -- captures (tests/test_torch_stream.py's, made by urh_tpu's modulate) -----------

BITS = np.resize(np.array([1, 0, 1, 1, 0, 0, 1, 0], np.uint8), 64)


def _fsk(n_copies=8, seed=0):
    one = modulate(BITS, 20, "fsk", [-20e3, 20e3], sample_rate=1e6, pause=1200)
    x = np.tile(one, (n_copies, 1))
    return (x + np.random.default_rng(seed).normal(0, 0.002, x.shape)).astype(np.float32)


def _ask(n_copies=8):
    bits = np.resize(np.array([1, 0, 1, 1, 0, 0, 1, 1], np.uint8), 64)
    one = modulate(bits, 20, "ask", [0.0, 1.0], sample_rate=1e6, pause=1200)
    x = np.tile(one, (n_copies, 1)) * 0.9
    return (x + np.random.default_rng(1).normal(0, 0.002, x.shape)).astype(np.float32)


def _fsk8():
    rng = np.random.default_rng(11)
    symbols = rng.integers(0, 8, 48)
    bits = np.array([(s >> k) & 1 for s in symbols for k in (2, 1, 0)], np.uint8)
    one = modulate(bits, 60, "fsk", list(np.linspace(-35e3, 35e3, 8)), sample_rate=1e6,
                   bits_per_symbol=3, pause=1500)
    return np.tile(one, (3, 1)).astype(np.float32)


def _psk():
    """About 20k samples of BPSK (the plain Costas loop steps sample by sample)."""
    bits = np.resize([1, 0, 1, 1, 0, 0, 1, 0], 48)
    one = modulate(bits, 100, "psk", [0.0, np.pi], sample_rate=1e6, pause=2500)
    x = np.tile(one, (3, 1))[:20000]
    return (x + np.random.default_rng(4).normal(0, 0.02, x.shape)).astype(np.float32)


# ProtocolSniffer's (samples_per_symbol, center, center_spacing, noise,
# tolerance, modulation_type, bits_per_symbol) and capture
SNIFF_CASES = {
    "fsk": ((20, 0.0, 0.1, 1e-2, 3, "FSK", 1), _fsk),
    "ask": ((20, 0.3, 0.1, 1e-2, 3, "ASK", 1), _ask),
    "fsk8": ((60, 0.0, 2 * np.pi * 10e3 / 1e6, 0.01, 5, "FSK", 3), _fsk8),
    "psk": ((100, 0.0, 0.1, 0.1, 5, "PSK", 1), _psk),
}


def _uneven(x, seed):
    """x cut into chunks of 1 to 6,000 samples, a seeded sequence."""
    cuts = np.cumsum(np.random.default_rng(seed).integers(1, 6000, len(x)))
    return np.split(x, cuts[cuts < len(x)])


def _sniffers(args, adaptive=False):
    """urh_tpu's sniffer and the port's on the CPU, streams made."""
    jax_sniffer = JaxSniffer(*args, NETWORK_SDR, JaxBackendHandler(), network_raw_mode=True)
    port = ProtocolSniffer(*args, NETWORK_SDR, BackendHandler(), network_raw_mode=True,
                           compute_device="cpu")
    for s in (jax_sniffer, port):
        s.adaptive_noise = adaptive
        s._stream = s._make_stream()
    return jax_sniffer, port


def _messages(sniffer):
    return [(m.plain_bits_str, m.pause) for m in sniffer.messages]


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed_noise", "adaptive_noise"])
@pytest.mark.parametrize("case", sorted(SNIFF_CASES))
def test_sniffer_ingest_equals_urh_tpu(receive_buffer, case, adaptive):
    args, capture = SNIFF_CASES[case]
    x = capture()
    jax_sniffer, port = _sniffers(args, adaptive)
    for chunk in _uneven(x, seed=len(case)):
        jax_sniffer._ingest(chunk)
        port._ingest(chunk)
    for s in (jax_sniffer, port):
        s._emit_segments(s._stream.flush())
    assert len(port.messages) >= 3
    assert _messages(port) == _messages(jax_sniffer)
    assert port.signal.noise_threshold == pytest.approx(jax_sniffer.signal.noise_threshold,
                                                        rel=1e-6)
    if case in ("fsk", "ask"):
        assert port._stream.backend == "device"


@pytest.mark.parametrize("route", ["device", "host", "adaptive_noise"])
def test_sniffer_emits_a_message_in_the_drain_that_fed_its_end(route):
    """A telegram, then one pause gate of silence, then another: the message
    leaves during the second ingest on every route.  On the device route the
    sniffer settles each chunk's own bundle (one ``stream.settled`` an
    ingest); the host route and adaptive noise consume at once and settle
    nothing."""
    args = SNIFF_CASES["fsk"][0]
    port = ProtocolSniffer(*args, NETWORK_SDR, BackendHandler(), network_raw_mode=True,
                           compute_device="cpu")
    port.adaptive_noise = route == "adaptive_noise"
    port._stream = port._make_stream()
    if route == "host":
        port._stream.backend = "host"
    telegram = _fsk(1)[:-1200]  # without its closing pause
    silence = np.zeros((PAUSE_GATE_SYMBOLS * args[0], 2), np.float32)
    metrics.metrics.clear()
    emitted = []
    for chunk in (telegram, silence, silence):
        port._ingest(chunk)
        emitted.append(len(port.messages))
    assert emitted == [0, 1, 1]
    assert port.messages[0].plain_bits_str == "".join(map(str, BITS))
    assert metrics.metrics.counters().get("stream.settled", 0) == (3 if route == "device"
                                                                   else 0)
    assert port._stream.flush() == []


def _feed_through_ring(sniffer, x, chunk):
    """Write x into the sniffer's receive ring as the Network SDR's sink
    does, draining after every write as the poll loop does."""
    dev = sniffer.rcv_device.underlying_device
    sink_cls = (network_sdr.SampleSink if isinstance(sniffer, ProtocolSniffer)
                else jax_network_sdr.SampleSink)
    dev._sample_sink = sink_cls(dev.receive_buffer)
    pos = 0
    for i in range(0, len(x), chunk):
        dev._sample_sink(x[i:i + chunk])
        pos = sniffer._drain_ring(pos)
    sniffer._emit_segments(sniffer._stream.flush())
    return sniffer._stream._fed


def test_ring_wrap_splices_stale_samples_and_the_port_follows(monkeypatch):
    """C5: the sink restarts at index 0 when a write would pass the end of the
    buffer, and the drain then reads [drain position, end) of the previous
    lap before [0, write index): a 39,680-sample capture written in chunks of
    3,500 through a 12,000-sample buffer is fed as 44,180 samples, and urh_tpu
    cuts 2 of its 16 messages in two (18 messages, 14 of them exact).  The port gives the same messages."""
    monkeypatch.setattr(jax_settings, "OVERWRITE_RECEIVE_BUFFER_SIZE", 12000)
    monkeypatch.setattr(settings, "OVERWRITE_RECEIVE_BUFFER_SIZE", 12000)
    x = _fsk(16)
    sent = "".join(map(str, BITS))
    jax_sniffer, port = _sniffers(SNIFF_CASES["fsk"][0])
    fed = [_feed_through_ring(s, x, 3500) for s in (jax_sniffer, port)]
    assert fed == [44180, 44180] and len(x) == 39680
    bits = [m.plain_bits_str for m in jax_sniffer.messages]
    assert len(bits) == 18 and sum(b == sent for b in bits) == 14
    assert _messages(port) == _messages(jax_sniffer)
    # without a wrap every message comes through
    monkeypatch.setattr(jax_settings, "OVERWRITE_RECEIVE_BUFFER_SIZE", 50000)
    monkeypatch.setattr(settings, "OVERWRITE_RECEIVE_BUFFER_SIZE", 50000)
    for s in _sniffers(SNIFF_CASES["fsk"][0]):
        assert _feed_through_ring(s, x, 3500) == len(x)
        assert [m.plain_bits_str for m in s.messages] == [sent] * 16


def _wait_drained(sniffer, total, deadline_s=DEADLINE_S):
    """Until the receive index reached ``total`` samples and the sniffer
    fed all of them."""
    dev = sniffer.rcv_device
    _wait(lambda: dev.current_index == total and sniffer.drain_position == total,
          deadline_s, f"{total} samples received and drained")


def _port_modulator(mt="FSK", sps=100):
    m = Modulator("test")
    m.samples_per_symbol = sps
    m.sample_rate = 1e6
    m.modulation_type = mt
    m.parameters[1] = 20e3
    m.parameters[0] = 10e3
    return m


def test_protocol_sniffer_over_loopback(receive_buffer):
    """tests/test_device_layer.py::test_protocol_sniffer's case on the port."""
    sps = 100
    sniffer = ProtocolSniffer(sps, 0.0942, 0.1, 0.1, 2, "FSK", 1, NETWORK_SDR, BackendHandler(),
                              network_raw_mode=True, compute_device="cpu")
    sniffer.rcv_device.set_server_port(0)
    sniffer.sniff()
    port = sniffer.rcv_device.underlying_device.server_port
    sender = network_sdr.NetworkSDRInterfacePlugin(raw_mode=True, sending=True)
    sender.client_port = port
    data = ["101010", "000111", "1111000"]
    modulator = _port_modulator()
    packages = [modulator.modulate(list(map(int, d)), 10 * sps, device="cpu") for d in data]
    send = IQData.concatenate(packages)
    sender.send_raw_data(send, 1)
    silence = IQData(None, np.float32, 10 * 2 * sps)  # flushes the last message
    sender.send_raw_data(silence, 1)
    _wait_drained(sniffer, len(send) + len(silence))
    sniffer.stop()
    assert sniffer.plain_bits_str == data
    assert not sniffer.sniff_thread.is_alive()


class _GatedStream:
    """A stream whose feed waits for ``release``, recording the order of
    feeds and the flush."""

    def __init__(self, inner):
        self.inner, self.events = inner, []
        self.entered, self.release = threading.Event(), threading.Event()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def feed(self, chunk):
        self.events.append("feed")
        self.entered.set()
        self.release.wait(DEADLINE_S)
        out = self.inner.feed(chunk)
        self.events.append("fed")
        return out

    def flush(self):
        self.events.append("flush")
        return self.inner.flush()


def _gated_sniffer(monkeypatch):
    sniffer = ProtocolSniffer(*SNIFF_CASES["fsk"][0], NETWORK_SDR, BackendHandler(),
                              network_raw_mode=True, compute_device="cpu")
    make = sniffer._make_stream
    monkeypatch.setattr(sniffer, "_make_stream", lambda: _GatedStream(make()))
    sniffer.rcv_device.set_server_port(0)
    sniffer.sniff()
    sender = network_sdr.NetworkSDRInterfacePlugin(raw_mode=True, sending=True)
    sender.client_port = sniffer.rcv_device.underlying_device.server_port
    sender.send_raw_data(IQData(_fsk(2), skip_conversion=True), 1)
    _wait(sniffer._stream.entered.is_set, what="a feed in flight")
    return sniffer


def test_stop_waits_for_the_feed_in_flight_before_flushing(receive_buffer, monkeypatch):
    """urh_tpu's stop() joins the poll thread for 0.1 s and flushes while a
    feed may still run on it; the port joins until the thread has left
    the feed, so feed and flush never overlap."""
    sniffer = _gated_sniffer(monkeypatch)
    stopper = threading.Thread(target=sniffer.stop)
    stopper.start()
    _wait(lambda: not sniffer.is_running, what="stop() called")
    stopper.join(0.3)
    assert stopper.is_alive() and sniffer._stream.events == ["feed"]
    sniffer._stream.release.set()
    stopper.join(DEADLINE_S)
    assert not stopper.is_alive() and not sniffer.sniff_thread.is_alive()
    assert sniffer._stream.events == ["feed", "fed", "flush"]


def test_stop_raises_when_the_poll_thread_never_stops(receive_buffer, monkeypatch):
    monkeypatch.setattr(sniffer_module, "STOP_JOIN_S", 0.2)
    sniffer = _gated_sniffer(monkeypatch)
    with pytest.raises(RuntimeError, match="still running"):
        sniffer.stop()
    assert sniffer._stream.events == ["feed"]  # no flush
    sniffer._stream.release.set()
    sniffer.sniff_thread.join(DEADLINE_S)
    assert not sniffer.sniff_thread.is_alive()


# -- the Network SDR across packages --------------------------------------------

@pytest.mark.parametrize("direction", ["urh_tpu_to_port", "port_to_urh_tpu"])
def test_network_sdr_raw_mode_across_packages(receive_buffer, direction):
    rx_mod, tx_mod, tx_iq = ((network_sdr, jax_network_sdr, JaxIQData)
                             if direction == "urh_tpu_to_port"
                             else (jax_network_sdr, network_sdr, IQData))
    receiver = rx_mod.NetworkSDRInterfacePlugin(raw_mode=True,
                                                resume_on_full_receive_buffer=True)
    receiver.server_port = 0
    receiver.start_tcp_server_for_receiving()
    sender = tx_mod.NetworkSDRInterfacePlugin(raw_mode=True, sending=True)
    sender.client_port = receiver.server_port
    data = np.random.default_rng(5).normal(size=(70001, 2)).astype(np.float32)
    sender.send_raw_data(tx_iq(data, skip_conversion=True), 1)
    _wait(lambda: receiver.current_receive_index == len(data))
    received = np.array(receiver.received_data)
    receiver.stop_tcp_server()
    np.testing.assert_array_equal(received, data)


@pytest.mark.parametrize("direction", ["urh_tpu_to_port", "port_to_urh_tpu"])
def test_network_sdr_bit_mode_across_packages(direction):
    rx_mod, tx_mod, message = ((network_sdr, jax_network_sdr, JaxMessage)
                               if direction == "urh_tpu_to_port"
                               else (jax_network_sdr, network_sdr, Message))
    receiver = rx_mod.NetworkSDRInterfacePlugin(raw_mode=False)
    receiver.server_port = 0
    receiver.start_tcp_server_for_receiving()
    sender = tx_mod.NetworkSDRInterfacePlugin(raw_mode=False, sending=True)
    sender.client_port = receiver.server_port
    bits = ["10101010", "0001110011110000", "1111000", "1" * 40]
    sender._send_messages([message.from_plain_bits_str(b, pause=0) for b in bits],
                          [1e6] * len(bits))
    _wait(lambda: len(receiver.received_bits) == len(bits))
    receiver.stop_tcp_server()
    # a line is whole bytes: bits padded with zeros to a byte
    assert receiver.received_bits == [b + "0" * (-len(b) % 8) for b in bits]


def _byte_stream():
    rng = np.random.default_rng(9)
    samples = rng.normal(size=(7, 2)).astype(np.float32).tobytes()
    lines = b"".join(network_sdr.bytes_from_bits(b) + b"\n"
                     for b in ("10101111", "0000000111", "1"))
    return samples, lines + network_sdr.bytes_from_bits("110011")  # an unterminated tail


def test_wire_decoders_equal_urh_tpus_at_every_cut():
    samples, lines = _byte_stream()
    for cut in range(len(samples) + 1):
        frames = []
        for mod in (network_sdr, jax_network_sdr):
            dec = mod.IQStreamDecoder(np.float32)
            frames.append(np.concatenate([dec.push(samples[:cut]), dec.push(samples[cut:])]))
        np.testing.assert_array_equal(frames[0], frames[1])
        assert frames[0].tobytes() == samples
    for cut in range(len(lines) + 1):
        out = []
        for mod in (network_sdr, jax_network_sdr):
            dec = mod.BitLineDecoder()
            out.append(dec.push(lines[:cut]) + dec.push(lines[cut:]) + dec.finish())
        assert out[0] == out[1] == ["10101111", "0000000111000000", "10000000", "11001100"]


def test_device_layer_tables_equal_urh_tpus():
    assert DEVICE_CONFIG == JAX_DEVICE_CONFIG
    got, want = BackendHandler(testing_mode=True), JaxBackendHandler(testing_mode=True)
    assert sorted(got.device_backends) == sorted(want.device_backends)
    for name, container in got.device_backends.items():
        other = want.device_backends[name]
        assert (container.selected_backend.name, container.supports_rx,
                container.supports_tx) == (other.selected_backend.name, other.supports_rx,
                                           other.supports_tx)
    for resume, spectrum in ((True, False), (True, True)):
        assert (settings.get_receive_buffer_size(resume, spectrum)
                == jax_settings.get_receive_buffer_size(resume, spectrum))
    calls = []
    event = Event(int)
    event.connect(calls.append)
    event.connect(calls.append)  # connected once
    event.emit(3)
    event.disconnect(calls.append)
    event.emit(4)
    assert calls == [3]


def test_native_sdr_backend_raises_until_ported():
    """A native backend builds the device urh_tpu builds (HackRF); a device
    with no binding in either package (FUNcube) raises the ValueError
    urh_tpu raises; the none backend builds."""
    hackrf = VirtualDevice(BackendHandler(testing_mode=True), "HackRF", Mode.receive)
    assert type(hackrf.underlying_device).__name__ == "HackRF"
    with pytest.raises(ValueError, match="vendor library"):
        VirtualDevice(BackendHandler(testing_mode=True), "FUNcube", Mode.receive)
    assert VirtualDevice(BackendHandler(), "no such device", Mode.receive).underlying_device \
        is None


def test_endless_sender_streams_pushed_samples(receive_buffer):
    receiver = network_sdr.NetworkSDRInterfacePlugin(raw_mode=True,
                                                     resume_on_full_receive_buffer=True)
    receiver.server_port = 0
    receiver.start_tcp_server_for_receiving()
    sender = EndlessSender(BackendHandler(), NETWORK_SDR)
    sender.device.set_client_port(receiver.server_port)
    data = np.random.default_rng(6).normal(size=(5000, 2)).astype(np.float32)
    sender.push_data(data[:3000])
    sender.start()
    sender.push_data(data[3000:])
    _wait(lambda: receiver.current_receive_index == len(data))
    sender.stop()
    receiver.stop_tcp_server()
    assert sender.ringbuffer.is_empty
    np.testing.assert_array_equal(np.array(receiver.received_data), data)


# -- TX --------------------------------------------------------------------------

def _assert_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    atol = FLOAT_ULPS * float(np.finfo(np.float32).eps)
    assert np.abs(got.astype(np.float64) - want).max() <= atol


def _tx_modulators(cls):
    out = []
    for name, mt, params in (("fsk", "FSK", [-20e3, 20e3]), ("ask", "ASK", [20.0, 100.0]),
                             ("psk", "PSK", [0.0, 180.0])):
        m = cls(name)
        m.modulation_type = mt
        m.samples_per_symbol = 50
        m.carrier_freq_hz = 0.0 if mt == "FSK" else 30e3
        m.parameters = params
        out.append(m)
    return out


def _container(cls, message_cls, n=6, n_bits=48, seed=3):
    rng = np.random.default_rng(seed)
    container = cls()
    container.messages = [message_cls.from_plain_bits_str(
        "".join(map(str, rng.integers(0, 2, n_bits))), pause=int(rng.integers(0, 3000)))
        for _ in range(n)]
    for i, msg in enumerate(container.messages):
        msg.modulator_index = i % 4  # 3 is out of range: falls back to 0
    return container


@pytest.fixture
def float32_tx(monkeypatch):
    """TX in float32 whatever the settings store holds."""
    monkeypatch.setattr(Modulator, "get_dtype", staticmethod(lambda: np.float32))
    monkeypatch.setattr(JaxModulator, "get_dtype", staticmethod(lambda: np.float32))


def test_generator_equals_urh_tpu(float32_tx):
    got = GeneratorBackend(_container(ProtocolAnalyzerContainer, Message),
                           _tx_modulators(Modulator), device="cpu")
    want = JaxGenerator(_container(JaxContainer, JaxMessage), _tx_modulators(JaxModulator))
    got_iq, want_iq = got.generate(), want.generate()
    assert got.total_modulated_samples == want.total_modulated_samples == len(got_iq)
    assert got.modulation_msg_indices == want.modulation_msg_indices
    _assert_close(got_iq.data, want_iq.data)


def _fuzz_container(cls, message_cls):
    container = cls()
    container.messages = [message_cls.from_plain_bits_str("101000001111", pause=500),
                          message_cls.from_plain_bits_str("1100110011001100", pause=700)]
    for msg, labels in zip(container.messages, (((4, 7, ["1010", "0000", "0001", "0010"]),
                                                 (8, 11, ["1111", "0000"])),
                                                ((0, 8, ["11001100", "11111111", "00000000",
                                                         "10101010"]),))):
        for start, end, values in labels:
            lbl = msg.message_type.add_protocol_label(start, end)
            lbl.fuzz_me = True
            lbl.fuzz_values = values
    return container


@pytest.mark.parametrize("mode", ["successive", "concurrent", "exhaustive"])
def test_container_fuzzing_equals_urh_tpu(mode):
    got, want = (_fuzz_container(ProtocolAnalyzerContainer, Message),
                 _fuzz_container(JaxContainer, JaxMessage))
    added = getattr(got, f"fuzz_{mode}")(default_pause=123)
    assert added == getattr(want, f"fuzz_{mode}")(default_pause=123)
    assert len(added) >= 4
    assert ([(m.plain_bits_str, m.pause, m.fuzz_created) for m in got.messages]
            == [(m.plain_bits_str, m.pause, m.fuzz_created) for m in want.messages])


def test_de_bruijn_equals_urh_tpu():
    from urh_tpu.protocol.container import de_bruijn as jax_de_bruijn
    from urh_tpu_torch.protocol.container import de_bruijn

    for n in range(1, 9):
        assert list(de_bruijn(n)) == list(jax_de_bruijn(n))


class _Cursor:
    value = 0


def _worker_samples(module, messages, modulators, device_kw):
    playlist = module._resolve_playlist(messages, modulators)
    ring = module.RingBuffer(1 << 18, np.float32)
    module._synthesis_worker(playlist, ring, _Cursor(), threading.Event(), 1, np.float32,
                             **device_kw)
    return ring.pop(-1)


def test_synthesis_worker_equals_urh_tpu(float32_tx):
    got_c = _container(ProtocolAnalyzerContainer, Message)
    want_c = _container(JaxContainer, JaxMessage)
    got = _worker_samples(cm, got_c.messages, _tx_modulators(Modulator), {"device": "cpu"})
    want = _worker_samples(jax_cm, want_c.messages, _tx_modulators(JaxModulator), {})
    assert len(got) > 10000
    _assert_close(got, want)
    # the same samples as the one-buffer generator, pauses included
    gen = GeneratorBackend(_container(ProtocolAnalyzerContainer, Message),
                           _tx_modulators(Modulator), device="cpu").generate()
    _assert_close(got, gen.data)


def test_continuous_modulator_child_feeds_a_sniffer(receive_buffer, float32_tx):
    """A real ContinuousModulator child on the CPU fills its ring, a
    continuous-send VirtualDevice drains the ring into a sniffer, every
    message comes back, and the child exits 0 after its one repeat."""
    sps = 100
    mod = _port_modulator(sps=sps)
    messages = [Message.from_plain_bits_str(b, pause=10 * sps)
                for b in ("101010", "000111", "1111000", "110011")]
    continuous = cm.ContinuousModulator(messages, [mod], num_repeats=1, device="cpu")
    assert continuous.device == "cpu" and continuous.ring_buffer.is_empty
    total = sum(len(m.encoded_bits) * sps + m.pause for m in messages)

    sniffer = ProtocolSniffer(sps, 0.0942, 0.1, 0.1, 2, "FSK", 1, NETWORK_SDR, BackendHandler(),
                              network_raw_mode=True, compute_device="cpu")
    sniffer.rcv_device.set_server_port(0)
    sniffer.sniff()
    sender = VirtualDevice(BackendHandler(), NETWORK_SDR, Mode.send)
    sender.set_client_port(sniffer.rcv_device.underlying_device.server_port)
    sender.continuous_send_ring_buffer = continuous.ring_buffer
    sender.is_send_continuous = True
    sender.num_samples_to_send = total
    sender.num_sending_repeats = 1

    continuous.start()
    _wait(lambda: not continuous.ring_buffer.is_empty, SPAWN_DEADLINE_S, "the ring filled")
    sender.start()
    continuous.process.join(SPAWN_DEADLINE_S)
    assert not continuous.is_running and continuous.process.exitcode == 0
    _wait(lambda: sender.sending_finished, what="the send")
    _wait_drained(sniffer, total)
    sniffer.stop()
    sender.stop("done")
    assert sniffer.plain_bits_str == ["101010", "000111", "1111000", "110011"]


# -- metrics -----------------------------------------------------------------------

def test_stage_metrics_report_as_urh_tpu():
    got, want = metrics.StageMetrics(), jax_metrics.StageMetrics()
    for m in (got, want):
        m.record("sniffer.demodulate", 1000, 0.25)
        m.record("sniffer.demodulate", 3000, 0.5)
        m.record("idle", 0, 0.0)
        with m.measure("measured", 10):
            pass
    g, w = got.report(), want.report()
    assert g["measured"]["calls"] == w["measured"]["calls"] == 1
    g.pop("measured"), w.pop("measured")
    assert g == w == {"sniffer.demodulate": {"samples": 4000, "seconds": 0.75, "calls": 2,
                                             "samples_per_second": 5333.3},
                      "idle": {"samples": 0, "seconds": 0.0, "calls": 1,
                               "samples_per_second": 0.0}}
    assert got.throughput("sniffer.demodulate") == want.throughput("sniffer.demodulate")
    got.clear()
    assert got.report() == {}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with metrics.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(1000).cumsum(0)
    assert prof is not None
    with open(tmp_path / "trace" / metrics.TRACE_FILE) as f:
        trace = json.load(f)
    assert any(e.get("name", "").startswith("aten::cumsum") for e in trace["traceEvents"])


def test_sniffer_records_its_feeds():
    metrics.metrics.clear()
    sniffer = ProtocolSniffer(*SNIFF_CASES["fsk"][0], NETWORK_SDR, BackendHandler(),
                              network_raw_mode=False, compute_device="cpu")
    sniffer._stream = sniffer._make_stream()
    x = _fsk(2)
    sniffer._ingest(x[:3000])
    sniffer._ingest(x[:0])  # an empty drain feeds nothing
    sniffer._ingest(x[3000:])
    report = metrics.metrics.report()["sniffer.demodulate"]
    assert (report["calls"], report["samples"]) == (2, len(x))
