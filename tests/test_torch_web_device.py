"""Device operation over the port's web API against urh_tpu's: counterparts
of tests/test_web_device.py (record, send, spectrum, live sniff, the
continuous send, backend selection, rfcat), hardware-free over the Network
SDR loopback.

Both apps (tests/torch_web_pair.py) get the same requests; each records,
sniffs and sends through devices of its own, and the same samples are sent
to both.  Replies are compared as in tests/test_torch_web_ui.py, with the
bound ports only checked to be bound; what a live route received or sent is
held against the bits sent, and the two packages' messages against each
other.  Timings are never compared, and every wait polls under a deadline.
urh_tpu's cases that read the golden fsk.complex read a synthetic FSK
capture of one message (torch_web_pair.FSK_BITS).
"""

import stat

import numpy as np
import pytest
import torch

from tests.torch_web_pair import (FSK_BITS, FSK_PARAMS, PACKAGES, config, fsk_iq,
                                  messages_of, pair, png_size, request, wait_until,
                                  write_capture)
from urh_tpu.dsp.modulator import Modulator as JaxModulator
from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.dev.network_sdr import NetworkSDRInterfacePlugin
from urh_tpu_torch.protocol.stream import PAUSE_GATE_SYMBOLS

torch.set_num_threads(1)

__all__ = ["config", "pair"]  # fixtures

LIVE_CENTER = 0.0942  # tests/test_web_device.py: tones at 10 and 20 kHz of 1 Msps
PORT_KEYS = ("port",)


def modulated_capture(bit_strings, pause=1000) -> np.ndarray:
    """tests/test_web_device.py's capture: FSK at 10/20 kHz, 100 samples a
    bit, made by urh_tpu's Modulator."""
    modulator = JaxModulator("webdev")
    modulator.samples_per_symbol = 100
    modulator.sample_rate = 1e6
    modulator.modulation_type = "FSK"
    modulator.parameters[0] = 10e3
    modulator.parameters[1] = 20e3
    return np.concatenate([modulator.modulate(list(map(int, b)), pause).data
                           for b in bit_strings]).astype(np.float32)


def send_to_port(port: int, samples: np.ndarray):
    sender = NetworkSDRInterfacePlugin(raw_mode=True, sending=True)
    sender.client_port = port
    sender.send_raw_data(IQData(samples, skip_conversion=True), 1)


class Receivers:
    """One Network SDR receiving server a package: where each app sends."""

    def __init__(self):
        self.plugins = {}
        for pkg in PACKAGES:
            receiver = NetworkSDRInterfacePlugin(raw_mode=True,
                                                 resume_on_full_receive_buffer=True)
            receiver.server_port = 0
            receiver.start_tcp_server_for_receiving()
            self.plugins[pkg] = receiver

    def port(self, pkg: str) -> int:
        return self.plugins[pkg].server_port

    def wait(self, total: int, timeout: float = 30.0) -> dict:
        for receiver in self.plugins.values():
            assert wait_until(lambda: receiver.current_receive_index >= total, timeout), (
                receiver.current_receive_index, total)
        return {pkg: np.asarray(r.received_data)[:r.current_receive_index]
                for pkg, r in self.plugins.items()}

    def close(self):
        for receiver in self.plugins.values():
            receiver.stop_tcp_server()


@pytest.fixture
def receivers():
    r = Receivers()
    try:
        yield r
    finally:
        r.close()


def with_port(body, receivers):
    """The body for each package, its client port that package's receiver."""
    return {pkg: dict(body, client_port=receivers.port(pkg)) for pkg in PACKAGES}


def each_body(pair, method, path, bodies):
    """Send each package its own body; -> pkg -> (status, reply)."""
    return {pkg: request(pair.servers[pkg], method, path, bodies[pkg])[:2] for pkg in PACKAGES}


def open_generator_table(pair, tmp_path, pause=2000):
    """The FSK capture's message in the generator table, to be sent at its
    own tones (the bootstrapped modulator's carrier is the capture's
    strongest tone), so that a receiver decodes it at center 0."""
    path = write_capture(tmp_path, "fsk.complex", fsk_iq(FSK_BITS))
    pair.call("POST", "/api/signal/open", {"path": path})
    pair.call("POST", "/api/signal/0/params", FSK_PARAMS)
    status, r = pair.call("POST", "/api/generator/add", {"signal_id": 0})
    assert status == 200 and r["rows"] == 1
    pair.call("POST", "/api/generator/pause", {"pause": pause})
    status, _ = pair.call("POST", "/api/generator/modulator",
                          {"action": "edit", "index": 0, "carrier_freq_hz": 0.0,
                           "parameters": [-20e3, 20e3]})
    assert status == 200


def test_device_list_and_idle_status(pair):
    status, r = pair.call("GET", "/api/device/list")
    assert status == 200
    names = [d["name"] for d in r["devices"]]
    assert "Network SDR" in names and "HackRF" in names
    assert next(d for d in r["devices"] if d["name"] == "Network SDR")["available"]
    status, st = pair.call("GET", "/api/device/status")
    assert status == 200
    assert not (st["record"]["running"] or st["send"]["running"] or st["spectrum"]["running"])


def test_record_interpret_edit_tx_roundtrip(pair, receivers):
    bits = "10110010010110110110"
    capture = modulated_capture([bits])
    status, r = pair.call("POST", "/api/device/record/start",
                          {"device": "Network SDR", "server_port": 0, "sample_rate": 1e6},
                          ignore=PORT_KEYS)
    assert status == 200 and r["running"]
    for pkg, srv_ui in pair.uis.items():
        port = pair.uis[pkg]._device_port(srv_ui._devices["record"])
        assert port > 0
        send_to_port(port, capture)
    assert wait_until(lambda: all(
        ui._devices["record"].current_index >= len(capture) for ui in pair.uis.values()))
    status, r = pair.call("POST", "/api/device/record/stop", {})
    assert status == 200 and r["num_samples"] == len(capture)
    status, sig = pair.call("POST", "/api/device/record/save", {"name": "recorded"})
    assert status == 200
    sid = sig["id"]
    assert pair.ui.main.signal_frames[sid].signal.device == torch.device("cpu")
    pair.call("POST", f"/api/signal/{sid}/params",
              {"modulation_type": "FSK", "samples_per_symbol": 100, "center": LIVE_CENTER,
               "noise_threshold": 0.1, "tolerance": 2})
    status, msgs = pair.call("GET", f"/api/signal/{sid}/messages?view=0")
    assert msgs["messages"] == [bits]
    pair.call("POST", f"/api/signal/{sid}/edit",
              {"action": "crop", "start": 0, "end": sig["num_samples"]})
    status, msgs = pair.call("GET", f"/api/signal/{sid}/messages?view=0")
    assert msgs["messages"] == [bits]

    replies = each_body(pair, "POST", "/api/device/send/start",
                        with_port({"device": "Network SDR", "signal_id": sid, "repeats": 1},
                                  receivers))
    assert all(s == 200 and r["running"] for s, r in replies.values())
    total = replies["torch"][1]["total"]
    assert total == replies["jax"][1]["total"] == len(capture)
    assert wait_until(lambda: all(
        r["finished"] for _, r, _ in pair.each("GET", "/api/device/send/status").values()))
    status, st = pair.call("GET", "/api/device/send/status", ignore=PORT_KEYS + ("messages",))
    assert st["current_index"] == total
    pair.call("POST", "/api/device/send/stop", {})
    received = receivers.wait(total)
    np.testing.assert_array_equal(received["torch"], received["jax"])
    assert messages_of(received["torch"], LIVE_CENTER, 0.1, 2) == [bits]


def test_tx_generator_table(pair, receivers, tmp_path):
    open_generator_table(pair, tmp_path, pause=1000)
    replies = each_body(pair, "POST", "/api/device/send/start",
                        with_port({"device": "Network SDR", "source": "generator"}, receivers))
    assert all(s == 200 for s, _ in replies.values())
    total = replies["torch"][1]["total"]
    assert total == replies["jax"][1]["total"] > 0
    assert wait_until(lambda: all(
        r["finished"] for _, r, _ in pair.each("GET", "/api/device/send/status").values()))
    pair.call("POST", "/api/device/send/stop", {})
    received = receivers.wait(total)
    got, want = received["torch"], received["jax"]
    atol = 4 * float(np.finfo(np.float32).eps)  # tests/test_torch_modulate.py's FLOAT_ULPS
    assert got.shape == want.shape and np.abs(got.astype(np.float64) - want).max() <= atol
    assert messages_of(got, 0.0, 0.1) == [FSK_BITS]


def test_spectrum_route_returns_live_fft_frames(pair):
    status, r = pair.call("POST", "/api/device/spectrum/start",
                          {"device": "Network SDR", "server_port": 0, "sample_rate": 1e6},
                          ignore=PORT_KEYS)
    assert status == 200 and r["running"]
    n = 8192
    tone = np.exp(2j * np.pi * 0.1 * np.arange(n)).astype(np.complex64)
    data = np.column_stack((tone.real, tone.imag)).astype(np.float32)
    for ui in pair.uis.values():
        send_to_port(ui._device_port(ui._devices["spectrum"]), data)

    def peak_frequency(pkg):
        status, frame, _ = pair.each("GET", "/api/device/spectrum/frame?points=256")[pkg]
        if status != 200 or not frame["magnitudes"]:
            return None
        mags = np.asarray(frame["magnitudes"])
        return float(frame["freqs"][int(np.argmax(mags))]) if mags.max() > 0 else None

    for pkg in PACKAGES:
        peak = wait_until(lambda: peak_frequency(pkg))
        assert peak is not None and abs(peak - 100e3) < 5e3, (pkg, peak)
    replies = pair.each("GET", "/api/device/spectrum/waterfall?window=256")
    (status, png, ctype), (_, jax_png, _) = replies["torch"], replies["jax"]
    assert status == 200 and ctype == "image/png"
    assert png_size(png)[1] == png_size(jax_png)[1] == 256  # frequency rows: the window
    status, r = pair.call("POST", "/api/device/spectrum/retune", {"frequency": 433.92e6})
    assert status == 200 and r["frequency"] == pytest.approx(433.92e6)
    status, r = pair.call("POST", "/api/device/spectrum/stop", {})
    assert status == 200 and r["running"] is False


def test_live_sniff_into_analysis(pair):
    data = ["101010", "000111", "1111000"]
    status, r = pair.call("POST", "/api/sniffer/start",
                          {"device": "Network SDR", "server_port": 0, "samples_per_symbol": 100,
                           "center": LIVE_CENTER, "center_spacing": 0.1, "noise": 0.1,
                           "tolerance": 2, "modulation_type": "FSK"}, ignore=PORT_KEYS)
    assert status == 200 and r["running"]
    assert pair.ui._sniffer.compute_device == torch.device("cpu")
    capture = modulated_capture(data)
    gate = np.zeros((PAUSE_GATE_SYMBOLS * 100, 2), np.float32)
    for ui in pair.uis.values():
        port = ui._device_port(ui._sniffer.rcv_device)
        assert port > 0
        send_to_port(port, capture)
        # closes the last message, which leaves in the drain that fed it
        send_to_port(port, np.concatenate([gate, gate]))

    def sniffed():
        replies = pair.each("GET", "/api/sniffer/messages?view=0")
        return all(len(r["messages"]) >= len(data) for _, r, _ in replies.values())

    assert wait_until(sniffed)
    status, r = pair.call("GET", "/api/sniffer/messages?view=0")
    assert r["messages"] == data
    status, r = pair.call("POST", "/api/sniffer/stop", {})
    assert status == 200 and r["messages"] == len(data)
    status, r = pair.call("POST", "/api/sniffer/to_analysis", {})
    assert status == 200 and r["rows"] == len(data)
    status, rows = pair.call("GET", "/api/analysis/rows?view=0&decoded=1")
    assert [row["data"] for row in rows["rows"]] == data
    status, r = pair.call("POST", "/api/sniffer/start",
                          {"device": "Network SDR", "server_port": 0}, ignore=PORT_KEYS)
    assert status == 200 and r["running"]
    pair.call("POST", "/api/sniffer/stop", {})


def test_sniffer_restart_after_empty_session(pair):
    status, r = pair.call("POST", "/api/sniffer/start",
                          {"device": "Network SDR", "server_port": 0}, ignore=PORT_KEYS)
    assert status == 200
    status, r = pair.call("POST", "/api/sniffer/start",
                          {"device": "Network SDR", "server_port": 0})
    assert status == 400 and "already running" in r["error"]
    status, r = pair.call("POST", "/api/sniffer/stop", {})
    assert status == 200 and r["messages"] == 0
    status, r = pair.call("POST", "/api/sniffer/to_analysis", {})
    assert status == 400
    status, r = pair.call("POST", "/api/sniffer/start",
                          {"device": "Network SDR", "server_port": 0}, ignore=PORT_KEYS)
    assert status == 200 and r["running"]
    pair.call("POST", "/api/sniffer/stop", {})
    status, r = pair.call("GET", "/api/sniffer/messages")
    assert r == {"running": False, "messages": []}


def test_device_route_errors(pair):
    status, r = pair.call("GET", "/api/device/spectrum/frame")
    assert status == 400 and "error" in r
    status, r = pair.call("POST", "/api/device/record/save", {})
    assert status == 400 and "error" in r
    status, r = pair.call("POST", "/api/device/send/start", {"device": "Network SDR"})
    assert status == 400 and "not" not in r["error"][:3]
    status, r = pair.call("POST", "/api/device/record/start",
                          {"device": "Network SDR", "server_port": 0}, ignore=PORT_KEYS)
    assert status == 200
    status, r = pair.call("POST", "/api/device/record/start",
                          {"device": "Network SDR", "server_port": 0})
    assert status == 400 and "already running" in r["error"]
    status, r = pair.call("POST", "/api/device/record/stop", {})
    assert status == 200 and r["num_samples"] == 0
    status, r = pair.call("POST", "/api/device/record/save", {})
    assert status == 400 and r["error"] == "recording is empty"


def continuous_send(pair, receivers, repeats: int) -> tuple:
    replies = each_body(pair, "POST", "/api/device/send/start",
                        with_port({"device": "Network SDR", "continuous": True,
                                   "repeats": repeats}, receivers))
    assert all(s == 200 and r["continuous"] for s, r in replies.values())
    total = replies["torch"][1]["total"]
    assert total == replies["jax"][1]["total"] > 0
    return total, receivers.wait(total, timeout=60)


def test_continuous_generator_tx(pair, receivers, tmp_path):
    open_generator_table(pair, tmp_path)
    try:
        total, received = continuous_send(pair, receivers, 2)
        assert pair.ui._continuous_mod.device == "cpu"
    finally:
        pair.call("POST", "/api/device/send/stop", {})
    assert messages_of(received["torch"], 0.0, 1e-3) == [FSK_BITS] * 2
    assert messages_of(received["jax"], 0.0, 1e-3) == [FSK_BITS] * 2


def test_network_send_repeats_honored(pair, receivers, tmp_path):
    path = write_capture(tmp_path, "small.complex", modulated_capture(["10110010"], pause=500))
    status, sig = pair.call("POST", "/api/signal/open", {"path": path})
    assert status == 200
    try:
        replies = each_body(pair, "POST", "/api/device/send/start",
                            with_port({"device": "Network SDR", "signal_id": sig["id"],
                                       "repeats": 3}, receivers))
        assert all(s == 200 for s, _ in replies.values())
        total = replies["torch"][1]["total"]
        received = receivers.wait(3 * total)
    finally:
        pair.call("POST", "/api/device/send/stop", {})
    np.testing.assert_array_equal(received["torch"], received["jax"])
    assert len(received["torch"]) == 3 * total


def test_continuous_tx_qpsk_and_odd_total_completes(pair, receivers, tmp_path):
    open_generator_table(pair, tmp_path, pause=1999)  # odd
    status, m = pair.call("POST", "/api/generator/modulator",
                          {"action": "edit", "index": 0, "modulation_type": "FSK",
                           "bits_per_symbol": 2, "samples_per_symbol": 100,
                           "parameters": [-20e3, -10e3, 10e3, 20e3]})
    assert status == 200
    pair.call("POST", "/api/generator/cell", {"row": 0, "col": 0, "value": "1"})
    status, table = pair.call("GET", "/api/generator/table")
    assert status == 200
    try:
        total, received = continuous_send(pair, receivers, 1)
        assert total % 2 == 1
        status, st = pair.call("GET", "/api/device/send/status",
                               ignore=PORT_KEYS + ("current_index", "finished", "messages"))
        assert st["continuous"] and st["total"] == total
    finally:
        pair.call("POST", "/api/device/send/stop", {})
    assert all(len(r) == total for r in received.values())


def test_continuous_tx_with_int8_modulation_dtype(pair, receivers, tmp_path):
    status, r = pair.call("POST", "/api/project/settings", {"modulation_dtype": "int8"})
    assert status == 200 and r["modulation_dtype"] == "int8"
    open_generator_table(pair, tmp_path)
    try:
        total, received = continuous_send(pair, receivers, 1)
    finally:
        pair.call("POST", "/api/device/send/stop", {})
    assert messages_of(received["torch"], 0.0, 1e-3) == [FSK_BITS]


def test_device_backend_selection(pair):
    status, r = pair.call("POST", "/api/device/backend", {"device": "HackRF"})
    assert status == 200 and r["selected_backend"] in ("native", "grc", "none")
    assert r["supports_rx"] and r["supports_tx"]
    for backend in r["available_backends"]:
        status, r2 = pair.call("POST", "/api/device/backend",
                               {"device": "HackRF", "backend": backend})
        assert status == 200 and r2["selected_backend"] == backend
    status, r2 = pair.call("POST", "/api/device/backend", {"device": "HackRF", "enabled": False})
    assert status == 200 and r2["enabled"] is False
    status, devs = pair.call("GET", "/api/device/list")
    assert next(d for d in devs["devices"] if d["name"] == "HackRF")["available"] is False
    pair.call("POST", "/api/device/backend", {"device": "HackRF", "enabled": True})
    status, _ = pair.call("POST", "/api/device/backend", {"device": "NoSuchSDR"})
    assert status == 400
    status, _ = pair.call("POST", "/api/device/backend", {"device": "HackRF", "backend": "bogus"})
    assert status == 400


def test_rfcat_send_via_fake_executable(pair, tmp_path):
    fakes = {}
    for pkg in PACKAGES:
        log = tmp_path / f"{pkg}.log"
        fake = tmp_path / f"rfcat_{pkg}"
        fake.write_text("#!/usr/bin/env python3\nimport sys\n"
                        f"log = open({str(log)!r}, 'a', buffering=1)\n"
                        "for line in sys.stdin:\n    log.write(line)\n")
        fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
        fakes[pkg] = log
    open_generator_table(pair, tmp_path, pause=1000)
    body = {"executable": str(tmp_path / "rfcat_{pkg}")}
    status, r = pair.call("POST", "/api/device/rfcat/send", body)
    assert status == 200 and r["sending"] and r["messages"] == 1
    for log in fakes.values():
        assert wait_until(lambda: log.exists() and "RFxmit" in log.read_text(), timeout=15)
    assert wait_until(lambda: not any(
        r["rfcat"]["running"] for _, r, _ in pair.each("GET", "/api/device/status").values()))
    pair.call("POST", "/api/device/rfcat/stop", {})
    assert fakes["torch"].read_text() == fakes["jax"].read_text()
    assert "RFxmit(b" in fakes["torch"].read_text()
    status, _ = pair.call("POST", "/api/device/rfcat/send", {"executable": "/no/such/rfcat"})
    assert status == 400
