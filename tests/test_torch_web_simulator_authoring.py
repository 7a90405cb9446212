"""Simulator flow authoring over the port's web API against urh_tpu's:
counterparts of tests/test_web_simulator_authoring.py.

Both apps (tests/torch_web_pair.py) get the same requests and must give
the same JSON replies, exactly (the bound receive port is only checked to
be bound).  The authored external-program flow then runs in both apps at
once against the Network SDR loopback: each simulator's sniffer gets
Alice's message, and what each sender transmits is read from a TCP sink of
its own and demodulated: the same bits from both, the counter's value in
the external program's label.  urh_tpu's case runs the golden
external_program_simulator.py, not in this tree: this one runs a script
written to ``tmp_path`` that prints the counter value it is given as 10 bits.
"""

import re
import socket
import sys
import threading

import numpy as np
import pytest
import torch

from tests.torch_web_pair import PACKAGES, config, messages_of, pair, request, wait_until
from urh_tpu.dsp.modulator import Modulator as JaxModulator
from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.dev.network_sdr import NetworkSDRInterfacePlugin
from urh_tpu_torch.dsp.modulator import Modulator
from urh_tpu_torch.protocol.stream import PAUSE_GATE_SYMBOLS

torch.set_num_threads(1)

__all__ = ["config", "pair"]  # fixtures

PREAMBLE = "10101010"
SYNC = "1001"
BASE_BITS = PREAMBLE + SYNC + "0" * 12
LIVE_CENTER = 0.0942


@pytest.fixture
def float32_tx(monkeypatch):
    for cls in (Modulator, JaxModulator):
        monkeypatch.setattr(cls, "FORCE_DTYPE", np.float32)


def participants(pair):
    status, _ = pair.call("POST", "/api/project/participants",
                          {"action": "create", "name": "Alice", "shortname": "A"})
    assert status == 200
    status, r = pair.call("POST", "/api/project/participants",
                          {"action": "create", "name": "Bob", "shortname": "B",
                           "simulate": True})
    assert status == 200 and len(r["participants"]) == 2


def test_item_crud_and_validation(pair):
    participants(pair)
    status, counter = pair.call("POST", "/api/simulator/item",
                                {"action": "create", "type": "counter", "start": 3, "step": 2})
    assert status == 200 and counter["fields"]["start"] == 3
    status, msg = pair.call("POST", "/api/simulator/item",
                            {"action": "create", "type": "message", "bits": "1010",
                             "pause": 500, "source": 0, "destination": 1,
                             "message_type": "m1"})
    assert status == 200 and msg["fields"]["bits"] == "1010"
    assert msg["fields"]["source"] == 0 and msg["fields"]["destination"] == 1
    formula = f"item{counter['index']}.counter_value + 1"
    status, lbl = pair.call("POST", "/api/simulator/item",
                            {"action": "create", "type": "label", "parent": msg["index"],
                             "start": 0, "length": 4, "name": "data", "value_type_index": 2,
                             "formula": formula})
    assert status == 200 and lbl["fields"]["value_type"] == "Formula" and lbl["valid"]
    status, v = pair.call("POST", "/api/simulator/validate", {"expression": formula})
    assert status == 200 and v["valid"]
    assert f"item{counter['index']}.counter_value" in v["identifiers"]
    status, v = pair.call("POST", "/api/simulator/validate", {"expression": "1 +"})
    assert status == 200 and not v["valid"]
    status, _ = pair.call("POST", "/api/simulator/item", {"action": "create", "type": "rule"})
    assert status == 200
    status, items = pair.call("GET", "/api/simulator/items")
    cond = next(i for i in items["items"] if i["type"] == "SimulatorRuleCondition")
    condition = f"item{msg['index']}.data == 1"
    status, cond2 = pair.call("POST", "/api/simulator/item",
                              {"action": "edit", "item": cond["index"],
                               "condition": condition})
    assert status == 200 and cond2["fields"]["condition"] == condition and cond2["valid"]
    status, v = pair.call("POST", "/api/simulator/validate",
                          {"expression": "1 == 1", "is_formula": False})
    assert status == 200 and not v["valid"]
    status, goto = pair.call("POST", "/api/simulator/item",
                             {"action": "create", "type": "goto",
                              "goto_target": f"item{msg['index']}"})
    assert status == 200 and goto["valid"]
    for kind in ("sleep", "trigger"):
        status, _ = pair.call("POST", "/api/simulator/item", {"action": "create", "type": kind})
        assert status == 200
    status, msg2 = pair.call("POST", "/api/simulator/item",
                             {"action": "edit", "item": msg["index"], "bits": "111100001111"})
    assert status == 200 and msg2["fields"]["bits"] == "111100001111"
    status, _ = pair.call("POST", "/api/simulator/item",
                          {"action": "move", "item": goto["index"], "pos": 0})
    assert status == 200
    status, items = pair.call("GET", "/api/simulator/items")
    goto_index = next(i["index"] for i in items["items"] if i["type"] == "SimulatorGotoAction")
    status, _ = pair.call("POST", "/api/simulator/item",
                          {"action": "delete", "item": goto_index})
    assert status == 200
    status, r = pair.call("POST", "/api/simulator/item", {"action": "create", "type": "bogus"})
    assert status == 400
    status, r = pair.call("POST", "/api/simulator/item",
                          {"action": "create", "type": "label", "parent": counter["index"]})
    assert status == 400 and "message parent" in r["error"]
    status, r = pair.call("POST", "/api/simulator/item",
                          {"action": "edit", "item": "99", "pause": 1})
    assert status == 400
    pair.call("GET", "/api/simulator/items")


class Sink:
    """A TCP server a simulator's sender connects to; keeps what arrives."""

    def __init__(self):
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.data = bytearray()
        self.lock = threading.Lock()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        try:
            conn, _ = self.sock.accept()
        except OSError:  # closed before a sender came
            return
        with conn:
            while True:
                chunk = conn.recv(65536)
                if not chunk:
                    return
                with self.lock:
                    self.data += chunk

    def samples(self) -> np.ndarray:
        with self.lock:
            usable = len(self.data) // 8 * 8
            return np.frombuffer(bytes(self.data[:usable]), np.float32).reshape(-1, 2)

    def close(self):
        self.sock.close()
        self.thread.join(10)


def test_author_and_run_external_program_flow(pair, float32_tx, tmp_path):
    participants(pair)
    status, r = pair.call("POST", "/api/project/settings",
                          {"simulator_timeout_ms": 8000, "simulator_retries": 2,
                           "simulator_num_repeat": 1})
    assert status == 200 and r["simulator_timeout_ms"] == 8000
    status, _ = pair.call("POST", "/api/generator/modulator",
                          {"action": "edit", "index": 0, "modulation_type": "FSK",
                           "samples_per_symbol": 100, "parameters": [10e3, 20e3]})
    assert status == 200
    status, counter = pair.call("POST", "/api/simulator/item",
                                {"action": "create", "type": "counter", "start": 3, "step": 2})
    status, msg1 = pair.call("POST", "/api/simulator/item",
                             {"action": "create", "type": "message", "bits": BASE_BITS,
                              "pause": 1000, "source": 0, "destination": 1,
                              "message_type": "m1"})
    status, msg2 = pair.call("POST", "/api/simulator/item",
                             {"action": "create", "type": "message", "bits": BASE_BITS,
                              "pause": 1000, "source": 1, "destination": 0,
                              "message_type": "m2"})
    assert status == 200
    program = tmp_path / "counter_bits.py"
    program.write_text("import sys\nsys.stdin.read()\nprint(format(int(sys.argv[1]), '010b'))\n")
    ext_program = f"{sys.executable} {program} item{counter['index']}.counter_value"
    status, lbl = pair.call("POST", "/api/simulator/item",
                            {"action": "create", "type": "label", "parent": msg2["index"],
                             "start": 12, "length": 10, "name": "payload",
                             "value_type_index": 3, "external_program": ext_program})
    assert status == 200 and lbl["valid"]
    status, _ = pair.call("POST", "/api/simulator/item",
                          {"action": "create", "type": "sleep", "sleep_time": 1e-9})
    status, _ = pair.call("POST", "/api/simulator/item",
                          {"action": "create", "type": "trigger",
                           "command": f"touch {tmp_path / '{pkg}_marker'}"})
    assert status == 200
    status, items = pair.call("GET", "/api/simulator/items")
    assert items["valid"]
    assert [i["type"] for i in items["items"] if "." not in i["index"]] == [
        "SimulatorCounterAction", "SimulatorMessage", "SimulatorMessage",
        "SimulatorSleepAction", "SimulatorTriggerCommandAction"]
    status, _ = pair.call("POST", "/api/simulator/save",
                          {"path": str(tmp_path / "{pkg}.sim.xml")})
    assert status == 200
    uuid = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
    saved = {pkg: uuid.sub("ID", (tmp_path / f"{pkg}.sim.xml").read_text()) for pkg in PACKAGES}
    assert saved["torch"] == saved["jax"].replace("jax_marker", "torch_marker")

    sinks = {pkg: Sink() for pkg in PACKAGES}
    try:
        replies = {pkg: request(pair.servers[pkg], "POST", "/api/simulator/start",
                                {"samples_per_symbol": 100, "center": LIVE_CENTER,
                                 "center_spacing": 0.1, "noise": 0.1, "tolerance": 2,
                                 "modulation_type": "FSK", "rx_server_port": 0,
                                 "tx_client_port": sinks[pkg].port})[:2]
                   for pkg in PACKAGES}
        assert all(s == 200 and r["running"] and r["rx_port"] > 0
                   for s, r in replies.values()), replies
        sim = pair.ui.main.simulator_tab_controller.simulator
        assert sim.device == torch.device("cpu")
        assert sim.sniffer.compute_device == torch.device("cpu")
        assert wait_until(lambda: all(any("Waiting for message" in m for m in r["log"])
                                      for _, r, _ in pair.each("GET", "/api/simulator/log")
                                      .values()))
        alice = JaxModulator("alice")
        alice.modulation_type = "FSK"
        alice.samples_per_symbol = 100
        alice.parameters[0], alice.parameters[1] = 10e3, 20e3
        message = alice.modulate(list(map(int, BASE_BITS))).data
        gate = IQData(np.zeros((PAUSE_GATE_SYMBOLS * 100, 2), np.float32),
                      skip_conversion=True)
        senders = {}
        for pkg in PACKAGES:
            senders[pkg] = NetworkSDRInterfacePlugin(raw_mode=True, sending=True)
            senders[pkg].client_port = replies[pkg][1]["rx_port"]
            senders[pkg].send_raw_data(IQData(message, skip_conversion=True), 1)
            # one gate of silence closes the message in the drain that fed it
            senders[pkg].send_raw_data(gate, 1)
        answers = {}
        for pkg in PACKAGES:
            answers[pkg] = wait_until(lambda: [b for b in messages_of(sinks[pkg].samples(), LIVE_CENTER, 0.1)
                                               if len(b) >= 22])
            assert answers[pkg], f"no answer from {pkg}'s simulator"
        assert answers["torch"][0] == answers["jax"][0]
        bits = answers["torch"][0]
        assert bits.startswith(PREAMBLE + SYNC)
        assert bits[12:22] in (format(3, "010b"), format(5, "010b")), bits
        assert wait_until(lambda: not any(
            r["running"] for _, r, _ in pair.each("GET", "/api/simulator/log").values()))
        for pkg in PACKAGES:
            assert (tmp_path / f"{pkg}_marker").exists()
        status, t = pair.call("GET", "/api/simulator/transcript")
        assert status == 200 and any(BASE_BITS in line for line in t["transcript"])
    finally:
        pair.call("POST", "/api/simulator/stop", {})
        for sink in sinks.values():
            sink.close()


def test_label_value_type_rejection_leaves_item_intact(pair):
    pair.call("POST", "/api/project/participants", {"action": "create", "name": "A"})
    pair.call("POST", "/api/project/participants",
              {"action": "create", "name": "B", "simulate": True})
    status, msg = pair.call("POST", "/api/simulator/item",
                            {"action": "create", "type": "message", "bits": "1010",
                             "source": 0, "destination": 1})
    assert status == 200
    status, lbl = pair.call("POST", "/api/simulator/item",
                            {"action": "create", "type": "label", "parent": msg["index"],
                             "start": 0, "length": 4, "name": "d"})
    assert status == 200
    status, _ = pair.call("POST", "/api/simulator/item",
                          {"action": "edit", "item": lbl["index"], "value_type_index": 99})
    assert status == 400
    status, items = pair.call("GET", "/api/simulator/items")
    assert status == 200
    got = next(i for i in items["items"] if i["index"] == lbl["index"])
    assert got["fields"]["value_type_index"] == 0


def test_simulator_load_over_http(pair, tmp_path):
    participants(pair)
    pair.call("POST", "/api/simulator/item",
              {"action": "create", "type": "message", "bits": BASE_BITS, "source": 0,
               "destination": 1})
    status, _ = pair.call("POST", "/api/simulator/save", {"path": str(tmp_path / "{pkg}.xml")})
    assert status == 200
    status, items = pair.call("POST", "/api/simulator/load",
                              {"path": str(tmp_path / "{pkg}.xml")})
    assert status == 200 and len(items["items"]) == 2
