"""The simulator and project persistence against urh_tpu's, on the CPU.

Both packages build the same simulation from the same seeded bits: the
expression language, the profile and project XML, and whole simulations
driven through a scripted sniffer and a recording sender (no sockets, no
sleeps ordering two steps) must give equal results.  Transcripts and log
lines (without their timestamps) are equal; the samples pushed to the
sender are held to tests/test_torch_modulate.py's tolerance, float32
within FLOAT_ULPS ulps of the amplitude.  The port's Simulator synthesizes
on ``device="cpu"``; urh_tpu's on the JAX CPU backend.

One loopback flow of the port alone, over the Network SDR, mirrors
tests/test_simulator.py::test_simulation_flow.
"""

import array
import re
import socket
import threading
import types
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import urh_tpu.coding.crc as jax_crc
import urh_tpu.dsp.modulator as jax_modulator
import urh_tpu.protocol.labels as jax_labels
import urh_tpu.protocol.message as jax_message
import urh_tpu.sim.configuration as jax_configuration
import urh_tpu.sim.expression_parser as jax_expression_parser
import urh_tpu.sim.items as jax_items
import urh_tpu.sim.simulator as jax_simulator
import urh_tpu.util.events as jax_events
import urh_tpu.util.project as jax_project
import urh_tpu_torch as ut
import urh_tpu_torch.coding.crc as crc
import urh_tpu_torch.dsp.modulator as modulator
import urh_tpu_torch.protocol.labels as labels
import urh_tpu_torch.protocol.message as message
import urh_tpu_torch.sim.configuration as configuration
import urh_tpu_torch.sim.expression_parser as expression_parser
import urh_tpu_torch.sim.items as items
import urh_tpu_torch.sim.simulator as simulator
import urh_tpu_torch.util.events as events
import urh_tpu_torch.util.project as project
from golden import drain_tx_stream, load_factor, wait_for_condition
from urh_tpu_torch.core.iq import IQData
from urh_tpu_torch.dev.backend_handler import BackendHandler
from urh_tpu_torch.dev.endless_sender import EndlessSender
from urh_tpu_torch.dev.network_sdr import NetworkSDRInterfacePlugin
from urh_tpu_torch.protocol.sniffer import ProtocolSniffer
from urh_tpu_torch.util import settings

torch.set_num_threads(1)

FLOAT_ULPS = 4  # tests/test_torch_modulate.py
SPS = 20
PREAMBLE, SYNC = "10101010", "10011010"
# preamble 8, sync 8, sequence number 8, data 8, CRC-16 over sequence number and data
LABELS = (("preamble", 0, 8), ("synchronization", 8, 8), ("sequence number", 16, 8),
          ("data", 24, 8), ("checksum", 32, 16))
CONSTANT, LIVE, FORMULA, EXTERNAL, RANDOM = range(5)

JAX = types.SimpleNamespace(
    name="urh_tpu", crc=jax_crc, modulator=jax_modulator, labels=jax_labels,
    message=jax_message, configuration=jax_configuration, parser=jax_expression_parser,
    items=jax_items, simulator=jax_simulator, events=jax_events, project=jax_project)
PORT = types.SimpleNamespace(
    name="urh_tpu_torch", crc=crc, modulator=modulator, labels=labels, message=message,
    configuration=configuration, parser=expression_parser, items=items,
    simulator=simulator, events=events, project=project)

STAMP = re.compile(r"^\w{3} \d+ \d\d:\d\d:\d\d\.\d{6}: ")


# -- building one simulation in either package --------------------------------------


def _project(pkg, policy=0, repeats=2, retries=3):
    pm = pkg.project.ProjectManager()
    alice = pkg.labels.Participant("Alice", "A", simulate=False, id="alice")
    bob = pkg.labels.Participant("Bob", "B", simulate=True, id="bob")
    pm.participants = [alice, bob]
    pm.simulator_timeout_ms = 1  # nothing arrives unscripted: a timeout is certain
    pm.simulator_retries = retries
    pm.simulator_num_repeat = repeats
    pm.simulator_error_handling_index = policy
    mod = pkg.modulator.Modulator("sim")
    mod.modulation_type = "FSK"
    mod.samples_per_symbol = SPS
    mod.parameters = [-20e3, 20e3]
    pm.modulators = [mod]
    config = pkg.configuration.SimulatorConfiguration(pm)
    parser = pkg.parser.SimulatorExpressionParser(config)
    config.attach_expression_parser(parser)
    return pm, config, parser, alice, bob


def _message(pkg, destination, source, name, values, bits=None):
    """A SimulatorMessage of LABELS; ``values``: label name -> (value type,
    attributes of the SimulatorProtocolLabel)."""
    bits = bits or PREAMBLE + SYNC + "0" * 32
    msg = pkg.items.SimulatorMessage(destination, list(map(int, bits)), pause=10 * SPS,
                                     message_type=pkg.labels.MessageType(name, id=name),
                                     source=source)
    mt = pkg.labels.MessageType(name + " labels")
    for lbl_name, start, length in LABELS:
        field_type = (pkg.labels.FieldType("checksum", pkg.labels.FieldType.Function.CHECKSUM)
                      if lbl_name == "checksum" else pkg.labels.FieldType.from_caption(lbl_name))
        lbl = mt.add_protocol_label_start_length(start, length, name=lbl_name, type=field_type)
        if lbl_name == "checksum":
            lbl.checksum = pkg.crc.GenericCRC(polynomial="16_standard")
            lbl.data_ranges = [[16, 32]]
        sim_lbl = pkg.items.SimulatorProtocolLabel(lbl)
        value_type, attrs = values.get(lbl_name, (CONSTANT, {}))
        sim_lbl.value_type_index = value_type
        for key, value in attrs.items():
            setattr(sim_lbl, key, value)
        msg.insert_child(-1, sim_lbl)
    return msg


def _scenario(pkg, policy=0):
    """item1 Alice -> Bob (RX; live sequence number and data, checked CRC);
    item2 a counter (start 1, step 2); item3 a rule: IF item1.sequence_number
    > 100: Bob answers sequence number + 1 and data = the counter; ELSE: Bob
    answers a random data byte, then goes to item5; item4 sleeps; item5
    triggers a command with the counter's value; item6 Bob sends data from
    an external program."""
    pm, config, parser, alice, bob = _project(pkg, policy)
    rx = _message(pkg, bob, alice, "rx", {"sequence number": (LIVE, {}), "data": (LIVE, {})})
    counter = pkg.items.SimulatorCounterAction()
    counter.start, counter.step = 1, 2
    rule = pkg.items.SimulatorRule()
    if_cond = pkg.items.SimulatorRuleCondition(pkg.items.ConditionType.IF)
    if_cond.condition = "item1.sequence_number > 100"
    else_cond = pkg.items.SimulatorRuleCondition(pkg.items.ConditionType.ELSE)
    answer = _message(pkg, alice, bob, "answer", {
        "sequence number": (FORMULA, {"formula": "item1.sequence_number + 1"}),
        "data": (FORMULA, {"formula": "item2.counter_value"})})
    random_answer = _message(pkg, alice, bob, "random", {
        "data": (RANDOM, {"random_min": 3, "random_max": 200})})
    goto = pkg.items.SimulatorGotoAction()
    sleep = pkg.items.SimulatorSleepAction()
    sleep.sleep_time = 0.001
    trigger = pkg.items.SimulatorTriggerCommandAction()
    trigger.command = "echo item2.counter_value"
    external = _message(pkg, alice, bob, "external",
                        {"data": (EXTERNAL, {"external_program": "printf 01100101"})})
    config.add_items([rx, counter, rule, sleep, trigger, external], 0, None)
    config.add_items([if_cond, else_cond], 0, rule)
    config.add_items([answer], 0, if_cond)
    config.add_items([random_answer, goto], 0, else_cond)
    goto.goto_target = "item5"
    config.update_item_dict()
    return pm, config, parser, alice, bob


def _alice_bits(pkg, seq: int, data: int, corrupt=False) -> str:
    body = format(seq, "08b") + format(data, "08b")
    checksum = pkg.crc.GenericCRC(polynomial="16_standard").calculate(
        array.array("B", map(int, body)))
    bits = PREAMBLE + SYNC + body + "".join(map(str, checksum))
    return bits[:-1] + str(1 - int(bits[-1])) if corrupt else bits


class Inbox(list):
    """The sniffer's ``messages``: each time the simulator looks into an
    empty inbox, the script's next entry arrives (bits; None: nothing, which
    the simulator sees as a receive timeout)."""

    def __init__(self, pkg, script):
        super().__init__()
        self.pkg, self.script = pkg, list(script)

    def __len__(self):
        if not list.__len__(self) and self.script:
            bits = self.script.pop(0)
            if bits is not None:
                self.append(self.pkg.message.Message.from_plain_bits_str(bits))
        return list.__len__(self)


class FakeDevice:
    def __init__(self, pkg):
        self.ready_for_action = pkg.events.Event()
        self.fatal_error_occurred = pkg.events.Event(str)
        self.data_type = np.float32


class FakeSniffer:
    def __init__(self, pkg, script):
        self.messages = Inbox(pkg, script)
        self.message_sniffed = pkg.events.Event(int)
        self.rcv_device = FakeDevice(pkg)

    def sniff(self):
        self.rcv_device.ready_for_action.emit()

    def stop(self):
        pass

    def clear(self):
        list.clear(self.messages)


class FakeSender:
    def __init__(self, pkg):
        self.device = FakeDevice(pkg)
        self.pushed = []

    def start(self):
        self.device.ready_for_action.emit()

    def stop(self):
        pass

    def push_data(self, data):
        self.pushed.append(np.array(data))


def _simulate(pkg, policy, script, seed=5):
    pm, config, parser, _, _ = _scenario(pkg, policy)
    assert config.protocol_valid()
    sniffer, sender = FakeSniffer(pkg, [_alice_bits(pkg, *s) if s else None for s in script]), \
        FakeSender(pkg)
    kwargs = {"device": "cpu"} if pkg is PORT else {}
    sim = pkg.simulator.Simulator(config, pm.modulators, parser, pm, sniffer, sender, **kwargs)
    np.random.seed(seed)  # the random label's values
    sim.start()
    sim.simulation_thread.join(30)
    assert not sim.simulation_thread.is_alive()
    return dict(transcript=sim.transcript.get_for_all_participants(all_rounds=True),
                log=[STAMP.sub("", line) for line in sim.log_messages],
                pushed=sender.pushed, repeat=sim.current_repeat)


# (policy, script: (sequence number, data[, corrupt]) or None for a timeout)
SCRIPTS = {
    "resend": (0, [None, (150, 9), None, (7, 44, True), (7, 44)]),
    "stop": (1, [(150, 9, True), (150, 9), None]),
    "restart": (2, [(150, 9), None, (201, 3), (7, 44)]),
    "not_received": (0, [(150, 9), (7, 44, True), None, None]),
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_simulations_equal_urh_tpu(case):
    """Rules, goto, counters, formulas, random and external labels, a sleep
    and a trigger command, with mismatches, retries and each of the three
    RX-failure policies (resend, stop, restart), and a message never
    received."""
    policy, script = SCRIPTS[case]
    want = _simulate(JAX, policy, script)
    got = _simulate(PORT, policy, script)
    assert got["transcript"] == want["transcript"]
    assert got["log"] == want["log"]
    assert got["repeat"] == want["repeat"]
    assert len(got["pushed"]) == len(want["pushed"]) > 0
    limit = FLOAT_ULPS * float(np.finfo(np.float32).eps)
    for g, w in zip(got["pushed"], want["pushed"]):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert np.abs(g.astype(np.float64) - w).max() <= limit
    log = "\n".join(got["log"])
    expected = {"resend": ("Resending last message", "Mismatch", "Finished"),
                "stop": ("Mismatch", "Receive timeout", "Stop simulation"),
                "restart": ("Restarting simulation", "Finished"),
                "not_received": ("Mismatch", "Message 1 not received")}[case]
    for text in expected:
        assert text in log, (text, log)


def test_simulation_takes_both_branches_of_the_rule():
    got = _simulate(PORT, 0, [(150, 9), (7, 44)])
    assert got["repeat"] == 2
    answers = [line.split(": ")[1] for line in got["transcript"] if "(B->A)" in line]
    # round 1: sequence number 151, data the counter (3); round 2: a random byte,
    # then the goto skips the sleep; item6's data from the external program
    assert int(answers[0][16:24], 2) == 151 and int(answers[0][24:32], 2) == 3
    assert answers[1][24:32] == "01100101"
    assert 3 <= int(answers[2][24:32], 2) <= 200
    assert "GOTO item 5" in "\n".join(got["log"])
    assert not any("Sleep" in line for line in got["log"][-12:])


# -- the expression language ---------------------------------------------------------

FORMULAS = ["item1.sequence_number + 1", "item1.data * 3 - item2.counter_value",
            "(item1.sequence_number | 0x0f) ^ 0b1010", "~item1.data & 0xff",
            "item1.data << 2 >> 1", "item1.sequence_number / 4", "-item2.counter_value + 0o10"]
CONDITIONS = ["item1.sequence_number > 100", "item1.data == 9 and not item2.counter_value < 1",
              "item1.sequence_number != 150 or item1.data >= 9", 'item1.data == "\\t"']
INVALID = ["item1.data ** 2", "__import__('os')", "item1.data +", "item1.data if 1 else 2",
           "item1.sequence_number == 1"]


def _evaluation_config(pkg):
    pm, config, parser, alice, bob = _project(pkg)
    rx = _message(pkg, bob, alice, "rx", {}, bits=_alice_bits(pkg, 150, 9))
    counter = pkg.items.SimulatorCounterAction()
    counter.start = 4
    counter.reset_value()
    config.add_items([rx, counter], 0, None)
    config.update_item_dict()
    return parser


@pytest.mark.parametrize("expr", FORMULAS)
def test_formula_equals_urh_tpu(expr):
    want = _evaluation_config(JAX).evaluate_formula(expr)
    assert _evaluation_config(PORT).evaluate_formula(expr) == want


@pytest.mark.parametrize("expr", CONDITIONS)
def test_condition_equals_urh_tpu(expr):
    want = _evaluation_config(JAX).evaluate_condition(expr)
    assert _evaluation_config(PORT).evaluate_condition(expr) == want


@pytest.mark.parametrize("expr", INVALID)
@pytest.mark.parametrize("is_formula", [True, False])
def test_validation_equals_urh_tpu(expr, is_formula):
    want = _evaluation_config(JAX).validate_expression(expr, is_formula)[:2]
    assert _evaluation_config(PORT).validate_expression(expr, is_formula)[:2] == want


# -- XML: profiles and projects ------------------------------------------------------


def _profile_xml(pkg, config) -> bytes:
    return ET.tostring(config.save_to_xml(standalone=True))


def _load_profile(pkg, xml: bytes):
    pm = pkg.project.ProjectManager()
    pm.participants = []
    config = pkg.configuration.SimulatorConfiguration(pm)
    config.attach_expression_parser(pkg.parser.SimulatorExpressionParser(config))
    config.load_from_xml(ET.fromstring(xml), message_types=[])
    return config


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["urh_tpu_to_port", "port_to_urh_tpu"])
def test_profile_written_by_one_package_loads_in_the_other(writer, reader):
    """A profile written by one package, loaded and written again by the
    other, is the XML the writer itself gives back (a first load turns the
    modulator's integer defaults into floats, in both packages), and
    another round trip changes nothing."""
    _, config, _, _, _ = _scenario(writer)
    xml = _profile_xml(writer, config)
    want = _profile_xml(writer, _load_profile(writer, xml))
    loaded = _load_profile(reader, xml)
    assert _profile_xml(reader, loaded) == want
    assert _profile_xml(reader, _load_profile(reader, want)) == want
    assert [i.index() for i in loaded.get_all_items()] == \
        [i.index() for i in config.get_all_items()]
    assert loaded.protocol_valid()


def _resave_project(pkg, path: str, out: str) -> str:
    """Load the project at ``path`` with its simulator profile into ``pkg``
    and save it under ``out``; -> the file's text."""
    pm = pkg.project.ProjectManager()
    assert pm.load_project(path)
    config = pkg.configuration.SimulatorConfiguration(pm)
    config.attach_expression_parser(pkg.parser.SimulatorExpressionParser(config))
    root = ET.parse(pm.project_file).getroot()
    config.load_from_xml(root.find("simulator_config"), message_types=[])
    pm.project_path = out
    pm.save_project(simulator_config=config)
    with open(pm.project_file) as f:
        return f.read()


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["urh_tpu_to_port", "port_to_urh_tpu"])
def test_project_save_and_load_equal_urh_tpu(tmp_path, writer, reader):
    pm, config, _, _, _ = _scenario(writer)
    pm.description = "two lines\nof description"
    pm.device_conf.update(frequency=433.92e6, sample_rate=2e6)
    pm.simulator_rx_conf.update(name="Network SDR")
    pm.project_path = str(tmp_path / "written")
    pm.save_project(simulator_config=config)
    want = _resave_project(writer, pm.project_path, str(tmp_path / "by_writer"))
    assert _resave_project(reader, pm.project_path, str(tmp_path / "by_reader")) == want
    assert _resave_project(reader, str(tmp_path / "by_reader"), str(tmp_path / "again")) == want
    loaded = reader.project.ProjectManager()
    loaded.load_project(pm.project_path)
    assert loaded.description == pm.description
    assert [(p.name, p.shortname, p.simulate) for p in loaded.participants] == \
        [(p.name, p.shortname, p.simulate) for p in pm.participants]


def test_decodings_file_equals_urh_tpu(tmp_path, monkeypatch):
    """load_decodings reads, and save_decodings_file writes, decodings.txt
    under the settings' config_dir(); both packages the same bytes."""
    from urh_tpu.util import settings as jax_settings

    for pkg, mod in ((JAX, jax_settings), (PORT, settings)):
        monkeypatch.setattr(mod, "_config_dir", str(tmp_path / pkg.name))
    fallback = []
    for pkg in (JAX, PORT):
        pm = pkg.project.ProjectManager()
        pm.load_decodings()  # no file: the fallback chains
        fallback.append([d.get_chain() for d in pm.decodings])
        pm.save_decodings_file()
    assert fallback[0] == fallback[1] and len(fallback[0]) == 5
    with open(tmp_path / "urh_tpu" / "decodings.txt") as a, \
            open(tmp_path / "urh_tpu_torch" / "decodings.txt") as b:
        assert a.read() == b.read()
    pm = PORT.project.ProjectManager()
    pm.load_decodings()
    assert [d.get_chain() for d in pm.decodings] == fallback[0]


# -- one loopback flow of the port alone -----------------------------------------------


def test_simulation_flow_over_the_network_sdr(monkeypatch):
    """tests/test_simulator.py::test_simulation_flow with the port on the
    CPU: Alice's message over loopback TCP to the sniffer, its CRC checked,
    Bob's answer (sequence number + 1) through an EndlessSender to a socket,
    demodulated by the port."""
    monkeypatch.setattr(settings, "OVERWRITE_RECEIVE_BUFFER_SIZE", 50000)
    pm, config, parser, alice, bob = _project(PORT, repeats=1, retries=5)
    pm.simulator_timeout_ms = int(8000 * load_factor())
    mod = pm.modulators[0]
    mod.samples_per_symbol = 100
    rx = _message(PORT, bob, alice, "rx", {"sequence number": (LIVE, {}), "data": (LIVE, {})})
    answer = _message(PORT, alice, bob, "answer", {
        "sequence number": (FORMULA, {"formula": "item1.sequence_number + 1"})})
    config.add_items([rx, answer], 0, None)
    assert config.protocol_valid()

    sniffer = ProtocolSniffer(100, 0.0, 0.1, 0.05, 2, "FSK", 1,
                              NetworkSDRInterfacePlugin.NETWORK_SDR_NAME, BackendHandler(),
                              network_raw_mode=True, compute_device="cpu")
    sniffer.rcv_device.set_server_port(0)
    sender = EndlessSender(BackendHandler(), NetworkSDRInterfacePlugin.NETWORK_SDR_NAME)
    sink = socket.socket()
    sink.bind(("127.0.0.1", 0))
    sink.listen(1)
    sender.device.set_client_port(sink.getsockname()[1])
    sim = simulator.Simulator(config, pm.modulators, parser, pm, sniffer, sender, device="cpu")
    sim.sniffer_ready = sim.sender_ready = True  # network devices have no handshake
    accepted = {}
    acceptor = threading.Thread(target=lambda: accepted.update(conn=sink.accept()[0]),
                                daemon=True)
    acceptor.start()
    try:
        sim.start()
        assert wait_for_condition(lambda: any("Waiting for message" in m
                                              for m in sim.log_messages), 15.0, 0.01)
        alice_tx = NetworkSDRInterfacePlugin(raw_mode=True, sending=True)
        alice_tx.client_port = sniffer.rcv_device.underlying_device.server_port
        bits = _alice_bits(PORT, 2, 0xcd)
        alice_tx.send_raw_data(mod.modulate(bits, pause=0, device="cpu"), 1)
        # a message ends after a pause gate (10 symbols) of silence, and the
        # sniffer emits it in the drain that fed the gate: one gate suffices
        assert wait_for_condition(lambda: sniffer.drain_position >= len(bits) * 100,
                                  15.0, 0.01)
        alice_tx.send_raw_data(IQData(None, np.float32, 1000), 1)
        assert wait_for_condition(lambda: any("Sending message 2" in m
                                              for m in sim.log_messages), 15.0, 0.01)
        acceptor.join(5)
        assert "conn" in accepted

        def decode(raw: bytes):
            usable = len(raw) // 8 * 8
            if not usable:
                return []
            iq = np.frombuffer(raw[:usable], np.float32).reshape(-1, 2)
            return [m.plain_bits_str for m in ut.demodulate(
                iq, ut.DemodParams(modulation="FSK", samples_per_symbol=100,
                                   noise_threshold=0.05), device="cpu")]

        received = drain_tx_stream(
            accepted["conn"], lambda raw: any(b.startswith(PREAMBLE + SYNC) for b in decode(raw)))
        answer_bits = next(b for b in decode(received) if b.startswith(PREAMBLE + SYNC))
        assert int(answer_bits[16:24], 2) == 3
        assert sim.transcript.get_for_all_participants(all_rounds=True)[0].endswith(bits)
    finally:
        sim.stop()
        sink.close()
        accepted.get("conn") and accepted["conn"].close()


# -- C7: a stop right after the last answer drops it (urh_tpu's own) ------------------


@pytest.mark.parametrize("pkg", ["urh_tpu", "urh_tpu_torch"])
def test_stop_right_after_a_push_drops_the_pushed_samples(pkg, monkeypatch):
    """The EndlessSender's thread looks into its ring every 0.1 s, and
    returns without sending when it finds stop() asked meanwhile: what the
    ring holds is dropped.  The simulator stops its sender as soon as the
    last round ends, so the last answer can be lost (ROADMAP C7).  The
    thread's sleep is held here until stop() has asked."""
    import time

    if pkg == "urh_tpu":
        from urh_tpu.dev import network_sdr as net
        from urh_tpu.dev.backend_handler import BackendHandler as handler
        from urh_tpu.dev.endless_sender import EndlessSender as sender_cls
    else:
        from urh_tpu_torch.dev import network_sdr as net
        handler, sender_cls = BackendHandler, EndlessSender
    sleeping, wake = threading.Event(), threading.Event()

    class HeldClock:
        def __getattr__(self, name):
            return getattr(time, name)

        def sleep(self, seconds):
            sleeping.set()
            wake.wait(30)

    monkeypatch.setattr(net, "time", HeldClock())
    sink = socket.socket()
    sink.bind(("127.0.0.1", 0))
    sink.listen(1)
    sink.settimeout(30)
    sender = sender_cls(handler(), NetworkSDRInterfacePlugin.NETWORK_SDR_NAME)
    sender.device.set_client_port(sink.getsockname()[1])
    sender.start()
    conn, _ = sink.accept()
    try:
        assert sleeping.wait(30)  # the thread waits on its empty ring
        sender.push_data(np.ones((1000, 2), np.float32))
        stopper = threading.Thread(target=sender.stop, daemon=True)
        stopper.start()
        assert wait_for_condition(lambda: sender.device._dev._interrupt, 30.0, 0.001)
        wake.set()
        stopper.join(30)
        assert not stopper.is_alive()
        conn.settimeout(30)
        assert conn.recv(1 << 16) == b""  # closed with nothing sent
    finally:
        wake.set()
        conn.close()
        sink.close()
