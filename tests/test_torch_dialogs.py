"""The port's dialog controllers against urh_tpu's: a counterpart of each
case of tests/test_dialog_controllers.py.

Each case runs the same steps on both packages' controllers, over labels,
messages and protocols built the same way in each, and compares what the
steps leave: label ranges and fuzz values, table rows, previews, events,
rulesets and parameter tables, all exactly.  The signal details dialog
reads a synthetic FSK capture written to ``tmp_path`` (urh_tpu's case reads
a golden capture that is not in this tree).
"""

import types

import numpy as np
import pytest
import torch

import urh_tpu as jax_ut
import urh_tpu_torch as ut
from urh_tpu.dsp.modulate import modulate as jax_modulate
from urh_tpu.protocol import analyzer as jax_analyzer
from urh_tpu.protocol import labels as jax_labels
from urh_tpu.protocol import message as jax_message
from urh_tpu.ui import dialogs as jax_dialogs
from urh_tpu_torch.protocol import analyzer, labels, message
from urh_tpu_torch.ui import dialogs

torch.set_num_threads(1)

JAX = types.SimpleNamespace(labels=jax_labels, Message=jax_message.Message,
                            ProtocolAnalyzer=jax_analyzer.ProtocolAnalyzer,
                            dialogs=jax_dialogs, Signal=jax_ut.Signal, device={})
TORCH = types.SimpleNamespace(labels=labels, Message=message.Message,
                              ProtocolAnalyzer=analyzer.ProtocolAnalyzer, dialogs=dialogs,
                              Signal=ut.Signal, device={"device": "cpu"})
FUZZ_BITS = "0001011001010001010011110000111100001111"


def make_message(pkg, bits="10110010010110110110110100101101", pause=1000):
    mt = pkg.labels.MessageType("test")
    mt.append(pkg.labels.ProtocolLabel(name="lbl1", start=4, end=23, color_index=0))
    return pkg.Message([int(b) for b in bits], pause, message_type=mt)


def both(scenario, *args):
    """Run ``scenario`` on urh_tpu and on the port; -> the port's trace,
    after asserting it equals urh_tpu's."""
    got, want = scenario(TORCH, *args), scenario(JAX, *args)
    assert got == want
    return got


def label_state(lbl):
    return (lbl.name, lbl.start, lbl.end, list(lbl.fuzz_values), lbl.apply_decoding)


# ---- ProtocolLabelDialog ------------------------------------------------------------


def label_edits(pkg):
    msg = make_message(pkg)
    ctrl = pkg.dialogs.ProtocolLabelDialogController(msg, view_type=0)
    trace = [ctrl.model.row_count, ctrl.model.row(0)]
    ctrl.model.set_field(0, "start", 2)
    ctrl.model.set_field(0, "end", 10)
    lbl = ctrl.model.label_at(0)
    trace.append(label_state(lbl))
    events = []
    ctrl.apply_decoding_changed.connect(lambda l, mt: events.append((l is lbl, mt.name)))
    ctrl.set_apply_decoding(0, False)
    ctrl.set_apply_decoding(0, False)  # unchanged: no event
    trace.append(list(events))
    removed = ctrl.remove_label(0)
    trace += [removed is lbl, ctrl.model.row_count, len(ctrl.checksum_widgets)]
    return trace


def test_protocol_label_dialog_edit_and_remove():
    trace = both(label_edits)
    assert trace[0] == 1 and trace[1]["start"] == 5 and trace[1]["end"] == 24
    assert trace[2][1:3] == (1, 10)
    assert trace[3] == [(True, "test")]
    assert trace[4:6] == [True, 0]


def checksum_tabs(pkg):
    msg = make_message(pkg)
    crc_lbl = pkg.labels.ChecksumLabel.from_label(msg.message_type[0])
    crc_lbl.field_type = pkg.labels.FieldType("checksum",
                                              pkg.labels.FieldType.Function.CHECKSUM)
    msg.message_type[0] = crc_lbl
    ctrl = pkg.dialogs.ProtocolLabelDialogController(msg, view_type=0)
    trace = [len(ctrl.checksum_widgets), ctrl.checksum_widgets[0].checksum_label is crc_lbl]
    ctrl.set_view_index(1)
    trace += [ctrl.checksum_widgets[0].proto_view, ctrl.model.proto_view]
    msg.message_type[0] = pkg.labels.ProtocolLabel(name="plain", start=4, end=23,
                                                   color_index=0)
    ctrl.configure_special_config_tabs()
    return trace + [len(ctrl.checksum_widgets)]


def test_protocol_label_dialog_checksum_tabs():
    assert both(checksum_tabs) == [1, True, 1, 1, 0]


# ---- MessageTypeDialog ----------------------------------------------------------------


def ruleset_state(mt):
    return (mt.assigned_by_ruleset, mt.ruleset.mode.value,
            [(r.start, r.end, r.operator, r.target_value, r.value_type) for r in mt.ruleset])


def message_type_rules(pkg, accept: bool):
    mt = pkg.labels.MessageType("rules")
    ctrl = pkg.dialogs.MessageTypeDialogController(mt)
    trace = [ctrl.ruleset_enabled]
    ctrl.set_assigned_automatically(True)
    trace.append(ctrl.ruleset_enabled)
    ctrl.add_rule()
    if not accept:
        ctrl.add_rule()
        ctrl.set_ruleset_mode(1)
        trace.append(ruleset_state(mt))
        ctrl.remove_rule()
    trace.append(ruleset_state(mt))
    ctrl.accept() if accept else ctrl.reject()
    return trace + [ruleset_state(mt), ctrl.accepted,
                    sorted(ctrl.ruleset_table_model.operator_descriptions)]


def test_message_type_dialog_rules_and_reject():
    trace = both(message_type_rules, False)
    assert trace[:2] == [False, True]
    assert len(trace[2][2]) == 2 and trace[2][1] == 1 and len(trace[3][2]) == 1
    assert trace[4] == (False, 0, []) and trace[5] is False


def test_message_type_dialog_accept_keeps_changes():
    trace = both(message_type_rules, True)
    assert trace[3][0] is True and len(trace[3][2]) == 1 and trace[4] is True


# ---- SignalDetailsDialog ----------------------------------------------------------------


@pytest.fixture
def fsk_capture(tmp_path):
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 64)
    iq = jax_modulate(bits, 100, "fsk", [-20e3, 20e3], carrier_frequency=0.0, pause=3000)
    iq = np.concatenate([np.zeros((1000, 2), np.float32), iq])
    path = tmp_path / "fsk.complex"
    (iq + rng.normal(0, 0.01, iq.shape)).astype(np.float32).tofile(path)
    return str(path)


def signal_details(pkg, path):
    sig = pkg.Signal.from_file(path, **pkg.device)
    ctrl = pkg.dialogs.SignalDetailsDialogController(sig)
    trace = [ctrl.name, ctrl.num_samples == sig.num_samples, ctrl.num_samples, ctrl.file,
             ctrl.file_size, ctrl.file_created]
    ctrl.sample_rate = 2e6
    trace += [sig.sample_rate, ctrl.sample_rate, ctrl.duration]
    ctrl.sample_rate = 1e6
    return trace + [ctrl.duration]


def test_signal_details_sample_rate_updates_duration(fsk_capture):
    trace = both(signal_details, fsk_capture)
    assert trace[1] and trace[3].endswith("fsk.complex") and trace[4] != "-"
    assert trace[6:8] == [2e6, 2e6]
    assert trace[8] != trace[9] and trace[9].endswith("s")


def missing_file(pkg):
    sig = pkg.Signal.from_samples(np.zeros((16, 2), dtype=np.float32), "mem", 1e6,
                                  **pkg.device)
    ctrl = pkg.dialogs.SignalDetailsDialogController(sig)
    return [ctrl.file, ctrl.file_size, ctrl.file_created, ctrl.name, ctrl.duration]


def test_signal_details_missing_file():
    trace = both(missing_file)
    assert trace[:3] == ["signal file not found", "-", "-"]


# ---- FuzzingDialog ----------------------------------------------------------------------


def fuzz_ctrl(pkg):
    proto = pkg.ProtocolAnalyzer(None)
    proto.messages.append(make_message(pkg, FUZZ_BITS, 0))
    return pkg.dialogs.FuzzingDialogController(proto, label_index=0, msg_index=0,
                                               proto_view=0)


def fuzz_state(ctrl):
    return (label_state(ctrl.current_label), ctrl.fuzz_table_model.row_count,
            ctrl.current_label_start, ctrl.current_label_end)


def fuzz_seeding(pkg):
    ctrl = fuzz_ctrl(pkg)
    return [fuzz_state(ctrl), ctrl.message_data, ctrl.message_data_preview()]


def test_fuzzing_current_label_seeding():
    (lbl, rows, start, end), data, _ = both(fuzz_seeding)
    assert lbl[3] == ["01100101000101001111"] and rows == 1
    assert (start, end) == (4, 24) and data[4:24] == "01100101000101001111"


def fuzz_views(pkg):
    """The preview in each of the three views."""
    ctrl = fuzz_ctrl(pkg)
    trace = []
    for view in (0, 1, 2):
        ctrl.proto_view = view
        trace.append((ctrl.message_data, ctrl.current_label_start, ctrl.current_label_end,
                      ctrl.message_data_preview()))
    return trace


def test_fuzzing_preview():
    pre, fuzzed, post = both(fuzz_views)[0][3]
    assert pre == "0001" and fuzzed == "0110010100010100..."
    assert post.startswith("0000111100")


def fuzz_steps(pkg, steps):
    ctrl = fuzz_ctrl(pkg)
    trace = []
    for name, args in steps:
        getattr(ctrl, name)(*args)
        trace.append(fuzz_state(ctrl))
    return trace


def test_fuzzing_add_remove_rows():
    trace = both(fuzz_steps, [("add_row", ()), ("add_row", ()), ("delete_lines", ()),
                              ("delete_lines", ()), ("delete_lines", (0, 0))])
    assert [s[1] for s in trace] == [2, 3, 2, 1, 1]
    values = trace[1][0][3]
    assert int(values[1], 2) == int(values[0], 2) + 1 == int(values[2], 2) - 1


def test_fuzzing_range_boundaries_random():
    trace = both(fuzz_steps, [("add_range", (10, 100, 20)), ("delete_lines", (1, 5)),
                              ("add_boundaries", (2, 200, 2)), ("delete_lines", (1, 4)),
                              ("add_random", (10, 0, 2 ** 20 - 1, 42))])
    assert [s[1] for s in trace] == [6, 1, 5, 1, 11]


def test_fuzzing_remove_duplicates():
    trace = both(fuzz_steps, [("add_range", (10, 50, 5))] * 3
                 + [("set_remove_duplicates", (True,)), ("add_range", (10, 50, 5))])
    assert [s[1] for s in trace] == [10, 19, 28, 10, 10]


def test_fuzzing_label_range_edit_clears_values():
    trace = both(fuzz_steps, [("add_range", (10, 100, 20)), ("set_fuzzing_start", (3,)),
                              ("set_fuzzing_end", (30,))])
    assert trace[0][1] > 1
    assert trace[1][0][1] == 2 and len(trace[1][0][3]) == 1
    assert trace[2][0][2] == 30


def test_fuzzing_repeat_values():
    trace = both(fuzz_steps, [("add_range", (10, 30, 10)), ("repeat_values", (1, 3, 2)),
                              ("set_remove_duplicates", (True,)),
                              ("repeat_values", (1, 2, 3))])
    before, values = trace[0][0][3], trace[1][0][3]
    assert len(values) == 8
    assert values[1] == values[2] == values[3] == before[1]
    assert values[4] == values[5] == values[6] == before[2]
    assert trace[2][1] == trace[3][1] == 4


def test_fuzzing_values_clamped_to_label_capacity():
    n_bits = 20
    cap = 2 ** n_bits - 1
    values = both(fuzz_steps, [("add_range", (cap - 1, cap + 5, 1))])[0][0][3]
    added = [int(v, 2) for v in values[1:]]
    assert added[0] == cap - 1 and all(v == cap for v in added[1:])
    assert all(len(v) == n_bits for v in values)


# ---- ModulationParametersDialog / AdvancedModulationOptions ------------------------------


def modulation_parameters(pkg):
    params = [0.0, 100.0, 200.0, 300.0]
    ctrl = pkg.dialogs.ModulationParametersDialogController(params, "4-FSK")
    trace = [ctrl.num_bits, ctrl.unit, [ctrl.bit_pattern(i) for i in range(4)]]
    ctrl.set_value(1, 150.0)
    trace.append(list(params))
    ctrl.accept()
    trace.append(list(params))
    return trace + [pkg.dialogs.ModulationParametersDialogController(p, mt).unit
                    for p, mt in (([0, 100], "ASK"), ([0, 180], "PSK"), ([0, 1], "OOK"))]


def test_modulation_parameters_dialog():
    trace = both(modulation_parameters)
    assert trace[:3] == [2, "Frequency in Hz", ["00", "01", "10", "11"]]
    assert trace[3] == [0.0, 100.0, 200.0, 300.0]
    assert trace[4] == [0.0, 150.0, 200.0, 300.0]
    assert trace[5:] == ["Amplitude", "Phase", ""]


def advanced_options(pkg, pause, divisor):
    ctrl = pkg.dialogs.AdvancedModulationOptionsController(8, 1)
    got = {}
    ctrl.pause_threshold_edited.connect(lambda v: got.setdefault("pause", v))
    ctrl.message_length_divisor_edited.connect(lambda v: got.setdefault("div", v))
    ctrl.set_pause_threshold(pause)
    ctrl.set_message_length_divisor(divisor)
    ctrl.accept()
    return got


@pytest.mark.parametrize("pause, divisor, want", [(8, 4, {"div": 4}), (9, 1, {"pause": 9}),
                                                  (8, 1, {})])
def test_advanced_modulation_options_controller(pause, divisor, want):
    assert both(advanced_options, pause, divisor) == want
