"""The port's tab controllers against urh_tpu's: counterparts of the
controller cases of tests/test_ui_layer.py (compare frame, generator tab,
main controller end to end, simulator tab).

urh_tpu's cases read a golden ASK capture that is not in this tree; these
take a synthetic one, made by urh_tpu.dsp.modulate.modulate (seeded noise)
and written as ``.complex`` to ``tmp_path``.  Both packages load it, the
port with ``device="cpu"`` (its demodulation then runs the fused kernels'
plain versions), and run the same steps.  Messages, labels, message
types, hidden rows, fuzzed values, simulator items and table rows are
compared exactly; generated samples within tests/test_torch_modulate.py's
FLOAT_ULPS float32 ulps of the amplitude (the two packages' cosine and
sine); the settings store lives in ``tmp_path``, so TX runs in float32.
"""

import types

import numpy as np
import pytest
import torch

from urh_tpu.dsp.modulate import modulate as jax_modulate
from urh_tpu.core.signal import Signal as JaxSignal
from urh_tpu.protocol import analyzer as jax_analyzer
from urh_tpu.protocol import labels as jax_labels
from urh_tpu.protocol import message as jax_message
from urh_tpu.ui import controllers as jax_controllers
from urh_tpu.util import settings as jax_settings
from urh_tpu_torch.core.signal import Signal
from urh_tpu_torch.protocol import analyzer, labels, message
from urh_tpu_torch.ui import controllers
from urh_tpu_torch.util import settings

torch.set_num_threads(1)

FLOAT_ULPS = 4  # tests/test_torch_modulate.py
ASK_SPS = 300
ASK_CENTER = 0.25

JAX = types.SimpleNamespace(name="jax", labels=jax_labels, Message=jax_message.Message,
                            ProtocolAnalyzer=jax_analyzer.ProtocolAnalyzer,
                            c=jax_controllers, Signal=JaxSignal, device={})
TORCH = types.SimpleNamespace(name="torch", labels=labels, Message=message.Message,
                              ProtocolAnalyzer=analyzer.ProtocolAnalyzer, c=controllers,
                              Signal=Signal, device={"device": "cpu"})


@pytest.fixture(autouse=True)
def config(tmp_path, monkeypatch):
    """Both packages' settings store in one temporary config dir."""
    folder = tmp_path / "config"
    for module in (settings, jax_settings):
        monkeypatch.setattr(module, "_config_dir", str(folder))
        monkeypatch.setattr(module, "_settings_file", str(folder / "settings.json"))
        monkeypatch.setattr(module, "_store", None)


@pytest.fixture
def ask_signal_path(tmp_path):
    """Four on/off-keyed messages of 40 random bits (each starting and
    ending with a 1) at 300 samples a bit on a 10 kHz tone."""
    rng = np.random.default_rng(21)
    parts = [np.zeros((3000, 2), np.float32)]
    for _ in range(4):
        bits = rng.integers(0, 2, 40)
        bits[0] = bits[-1] = 1
        parts.append(jax_modulate(bits, ASK_SPS, "ask", [0.0, 1.0], carrier_frequency=10e3,
                                  pause=12000))
    iq = np.concatenate(parts)
    path = tmp_path / "ask.complex"
    (iq + rng.normal(0, 0.01, iq.shape)).astype(np.float32).tofile(path)
    return str(path)


def make_frame(pkg, path):
    signal = pkg.Signal.from_file(path, **pkg.device)
    signal.params.modulation = "ASK"
    signal.params.samples_per_symbol = ASK_SPS
    signal.params.center = ASK_CENTER
    signal.params.pause_threshold = 20
    return pkg.c.SignalFrameController(signal)


def messages(proto):
    return [(m.plain_bits_str, m.pause, m.message_type.name,
             m.participant.name if m.participant else None) for m in proto.messages]


def message_types(proto):
    return [(mt.name, [(lbl.name, lbl.start, lbl.end) for lbl in mt])
            for mt in proto.message_types]


def both(scenario, *args):
    got, want = scenario(TORCH, *args), scenario(JAX, *args)
    assert got == want
    return got


def test_controllers_default_to_the_card_and_keep_the_device_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (controllers.CompareFrameController, controllers.GeneratorTabController,
                controllers.SimulatorTabController, controllers.MainController):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls()
    mc = controllers.MainController(device="cpu")
    tabs = (mc.compare_frame_controller, mc.generator_tab_controller,
            mc.simulator_tab_controller)
    assert mc.device == torch.device("cpu") and all(t.device == mc.device for t in tabs)
    assert mc.generator_tab_controller.backend.device == mc.device


# -- the compare frame -------------------------------------------------------------------


def show_only_modes(pkg):
    proto = pkg.ProtocolAnalyzer(None)
    for bits in ("10100101", "10101111", "10100111"):
        proto.messages.append(pkg.Message([int(b) for b in bits], 0,
                                          message_type=pkg.labels.MessageType("x")))
    cfc = pkg.c.CompareFrameController(**pkg.device)
    cfc.proto_analyzer.messages = proto.messages
    for msg in proto.messages:
        msg.message_type = cfc.proto_analyzer.default_message_type
    cfc.protocol_model.update()
    lbl = cfc.active_message_type.add_protocol_label(0, 3)
    cfc.protocol_model.update()
    trace = [cfc.get_visible_columns(), cfc.get_visible_columns(show_only_labels=True)]
    cfc.show_differences(0)
    trace += [cfc.get_visible_columns(show_only_diffs=True),
              cfc.get_visible_columns(show_only_labels=True, show_only_diffs=True)]
    lbl.show = False
    trace.append(cfc.get_visible_columns(show_only_labels=True))
    cfc.hide_differences()
    return trace + [cfc.get_visible_columns(show_only_diffs=True), cfc.protocol_model.refindex]


def test_compare_frame_show_only_modes():
    trace = both(show_only_modes)
    assert trace[:5] == [set(range(8)), {0, 1, 2, 3}, {4, 6}, set(), set()]
    assert trace[5] == {4, 6} and trace[6] == 0  # show-only-diffs turns the diff view on


def label_and_message_type(pkg, path):
    frame = make_frame(pkg, path)
    frame.show_protocol()
    cfc = pkg.c.CompareFrameController(**pkg.device)
    cfc.add_protocol(frame.proto_analyzer)
    trace = [messages(cfc.proto_analyzer), len(cfc.decodings) >= 5]
    lbl = cfc.add_protocol_label(0, 3, 0, proto_view=0)
    trace += [(lbl.start, lbl.end), lbl in cfc.active_message_type,
              cfc.get_labels_from_selection(0, 0, 0, 2) == [lbl],
              cfc.add_protocol_label(0, 3, 99, proto_view=0)]
    mt = cfc.add_message_type(cfc.proto_analyzer.messages)
    trace += [cfc.active_message_type is mt,
              all(m.message_type is mt for m in cfc.proto_analyzer.messages),
              message_types(cfc.proto_analyzer), cfc.search("1011"),
              sorted(cfc.visible_columns_for_labels())]
    return trace


def test_compare_frame_label_and_messagetype(ask_signal_path):
    trace = both(label_and_message_type, ask_signal_path)
    assert len(trace[0]) == 4 and trace[1]
    assert trace[2:6] == [(0, 4), True, True, False]
    assert trace[6] and trace[7]


def hidden_rows_by_participant(pkg, path):
    frame = make_frame(pkg, path)
    frame.show_protocol()
    cfc = pkg.c.CompareFrameController(**pkg.device)
    alice = pkg.labels.Participant("Alice", "A")
    cfc.project_manager.participants.append(alice)
    for msg in frame.proto_analyzer.messages[:3]:
        msg.participant = alice
    cfc.add_protocol(frame.proto_analyzer)
    trace = [sorted(cfc.protocol_model.hidden_rows)]
    alice.show = False
    cfc.set_shown_protocols()
    return trace + [sorted(cfc.protocol_model.hidden_rows), messages(cfc.proto_analyzer)]


def test_compare_frame_hidden_rows_by_participant(ask_signal_path):
    trace = both(hidden_rows_by_participant, ask_signal_path)
    assert trace[0] == [] and trace[1] == [0, 1, 2]


def format_finder(pkg, path):
    """awre over the merged analyzer: the compare frame runs it on its
    device (on the port's CPU here)."""
    frame = make_frame(pkg, path)
    frame.show_protocol()
    cfc = pkg.c.CompareFrameController(**pkg.device)
    for _ in range(3):
        cfc.add_protocol(frame.proto_analyzer)
    cfc.run_format_finder()
    return [message_types(cfc.proto_analyzer), cfc.active_message_type.name,
            [m.message_type.name for m in cfc.proto_analyzer.messages],
            len(cfc.message_type_table_model.message_types)]


def test_compare_frame_runs_awre_on_its_device(ask_signal_path):
    trace = both(format_finder, ask_signal_path)
    assert len(trace[2]) == 12 and trace[3] >= 1


# -- the generator tab -------------------------------------------------------------------


def generator_tab(pkg, path):
    frame = make_frame(pkg, path)
    frame.show_protocol()
    cfc = pkg.c.CompareFrameController(**pkg.device)
    cfc.add_protocol(frame.proto_analyzer)
    gtc = pkg.c.GeneratorTabController(cfc, **pkg.device)
    gtc.add_protocol(frame.proto_analyzer)
    m = gtc.modulators[0]
    trace = [len(gtc.protocol.messages),
             (m.samples_per_symbol, m.modulation_type, m.sample_rate, m.carrier_freq_hz,
              list(m.parameters))]
    lbl = gtc.create_fuzzing_label(0, 0, 4)
    lbl.fuzz_values.extend(["0000", "0001", "0010", "0011"])
    trace.append(list(lbl.fuzz_values))
    trace.append(list(gtc.fuzz("Successive")))  # undo clears the list it returns
    trace.append([m.plain_bits_str for m in gtc.protocol.messages])
    gtc.generator_undo_stack.undo()
    trace.append(len(gtc.protocol.messages))
    gtc.edit_all_pause_items(1000)
    gtc.edit_pause_item(1, 2000)
    trace += [list(gtc.pauses), gtc.estimated_time_s()]
    iq = gtc.generate_iq()
    trace.append((len(iq), gtc.total_modulated_samples))
    return trace, iq.data


def test_generator_tab_insert_fuzz_estimate(ask_signal_path):
    got, got_iq = generator_tab(TORCH, ask_signal_path)
    want, want_iq = generator_tab(JAX, ask_signal_path)
    assert got == want
    assert got[0] == 4 and got[1][:2] == (ASK_SPS, "ASK")
    assert len(got[3]) == 3 and got[5] == 4
    assert got[6][:2] == [1000, 2000] and got[7] > 0
    assert got[8][0] == got[8][1]
    assert got_iq.dtype == want_iq.dtype == np.float32
    atol = FLOAT_ULPS * float(np.finfo(np.float32).eps)
    assert np.abs(got_iq.astype(np.float64) - want_iq).max() <= atol


def test_generator_tab_sends_the_modulated_table(ask_signal_path):
    """send() hands the modulated table to a TX device object (an SDR)."""

    class Sink:
        def send_raw_data(self, data, repeats):
            self.data, self.repeats = np.array(data), repeats

    sinks = []
    for pkg in (TORCH, JAX):
        frame = make_frame(pkg, ask_signal_path)
        frame.show_protocol()
        gtc = pkg.c.GeneratorTabController(**pkg.device)
        gtc.add_protocol(frame.proto_analyzer)
        sinks.append(Sink())
        gtc.send(sinks[-1], repeats=3)
    got, want = sinks
    assert got.repeats == want.repeats == 3 and got.data.shape == want.data.shape
    atol = FLOAT_ULPS * float(np.finfo(np.float32).eps)
    assert np.abs(got.data.astype(np.float64) - want.data).max() <= atol


# -- the main controller -------------------------------------------------------------------


def main_controller(pkg, path, folder):
    mc = pkg.c.MainController(**pkg.device)
    frame = mc.add_signalfile(path)
    trace = [frame in mc.signal_frames, len(mc.compare_frame_controller.proto_analyzer.messages)]
    # the file's parameters demodulated it on opening; now the capture's own
    for name, value in (("modulation_type", "ASK"), ("samples_per_symbol", ASK_SPS),
                        ("center", ASK_CENTER), ("pause_threshold", 20)):
        frame.change_parameter(name, value)
    mc.compare_frame_controller.set_shown_protocols()
    trace += [messages(mc.compare_frame_controller.proto_analyzer), frame.signal.name,
              frame.selection_info(0, 20000), frame.undo_stack.count]
    txt = folder / "bits.txt"
    txt.write_text("101010101\n111100001111\n")
    proto = mc.add_files([str(txt)])[0]
    trace += [proto.num_messages, proto.name,
              len(mc.compare_frame_controller.proto_analyzer.messages)]
    frame.mute_range(0, 4000)
    frame.undo_stack.undo()
    trace.append(messages(frame.proto_analyzer))
    mc.close_signal_frame(frame)
    trace += [frame not in mc.signal_frames,
              len(mc.compare_frame_controller.proto_analyzer.messages)]
    mc.close_all_files()
    return trace + [mc.signal_frames, mc.undo_stack.count]


def test_main_controller_end_to_end(ask_signal_path, tmp_path):
    trace = both(main_controller, ask_signal_path, tmp_path)
    assert trace[0] and trace[1] >= 1 and len(trace[2]) == 4 and trace[3] == "ask"
    assert trace[4]["num_samples"] == 20000 and trace[5] == 4
    assert trace[6:9] == [2, "bits", 6]
    assert trace[9] == trace[2]
    assert trace[10:] == [True, 2, [], 0]


def test_main_controller_loads_signals_on_its_device(ask_signal_path, tmp_path):
    mc = controllers.MainController(device="cpu")
    frame = mc.add_files([ask_signal_path])[0]
    assert frame.signal.device == torch.device("cpu")
    mc.project_manager.project_path = str(tmp_path)
    mc.save_project()
    again = controllers.MainController(device="cpu")
    again.open_project(str(tmp_path))
    assert [f.signal.device for f in again.signal_frames] == [torch.device("cpu")]


# -- the simulator tab ------------------------------------------------------------------------


def simulator_tab(pkg, path):
    frame = make_frame(pkg, path)
    frame.show_protocol()
    cfc = pkg.c.CompareFrameController(**pkg.device)
    cfc.add_protocol(frame.proto_analyzer)
    gtc = pkg.c.GeneratorTabController(cfc, **pkg.device)
    stc = pkg.c.SimulatorTabController(cfc, gtc, **pkg.device)
    sim_msgs = stc.add_protocol_messages(frame.proto_analyzer.messages)
    trace = [len(sim_msgs), len(stc.messages), [m.plain_bits_str for m in stc.messages]]
    rule = stc.add_rule()
    trace.append(rule.child_count())
    stc.add_goto_action(goto_target="item1")
    trace += [stc.validate_formula("item1.data + 1"), stc.validate_formula("1 +")[0]]
    stc.simulator_message_table_model.update()
    trace.append(stc.simulator_message_table_model.row_count)
    trace.append([type(item).__name__ for item in stc.simulator_config.get_all_items()])
    return trace


def test_simulator_tab_controller_build(ask_signal_path):
    trace = both(simulator_tab, ask_signal_path)
    assert trace[0] == trace[1] == 4 and trace[3] == 1
    assert trace[5] is False and trace[6] == 4


def test_simulator_tab_builds_the_simulator_on_its_device():
    stc = controllers.SimulatorTabController(device="cpu")
    sim = stc.get_simulator()
    assert sim.device == torch.device("cpu") and stc.simulator is sim
    assert sim.modulators == []
