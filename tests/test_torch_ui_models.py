"""The port's UI model layer against urh_tpu's: the undo stack, the
undoable actions, the table models, the widget controllers, the PNG
writer and the plots.

Signals are synthetic ASK and FSK captures from urh_tpu's modulator
(seeded noise); the port demodulates them on the CPU through its fused
kernels' plain versions, urh_tpu on JAX's CPU.  After every edit and every
undo the samples are compared word for word and the messages bit for
bit, with their per-message metadata; the filter's samples within 1e-6
(the FIR's FFT in torch against NumPy's, unit-scale samples).  Table
models, label models, the widgets' controllers, PNG bytes and waveform
bitmaps are compared exactly.
"""

import copy

import numpy as np
import pytest
import torch

import urh_tpu as jax_ut
import urh_tpu_torch as ut
from urh_tpu.dsp.filters import Filter as JaxFilter
from urh_tpu.dsp.modulate import modulate as jax_modulate
from urh_tpu.plugins.insert_sine import InsertSinePlugin as JaxInsertSinePlugin
from urh_tpu.protocol import labels as jax_labels
from urh_tpu.protocol.analyzer import ProtocolAnalyzer as JaxProtocolAnalyzer
from urh_tpu.protocol.message import Message as JaxMessage
from urh_tpu.ui import actions as jax_actions
from urh_tpu.ui import models as jax_models
from urh_tpu.ui import plots as jax_plots
from urh_tpu.ui import png as jax_png
from urh_tpu.ui import undo as jax_undo
from urh_tpu.ui import widgets as jax_widgets
from urh_tpu.util import settings as jax_settings
from urh_tpu_torch.dsp.filters import Filter
from urh_tpu_torch.plugins.insert_sine import InsertSinePlugin
from urh_tpu_torch.protocol import labels
from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer
from urh_tpu_torch.protocol.message import Message
from urh_tpu_torch.ui import actions, models, plots, png, undo, widgets
from urh_tpu_torch.util import settings

torch.set_num_threads(1)

FILTER_ATOL = 1e-6
BANDPASS = (-0.08, 0.08, 0.08)  # a band-pass that keeps both FSK tones


@pytest.fixture
def config(tmp_path, monkeypatch):
    """Both packages' settings store in one temporary config dir, unread."""
    folder = tmp_path / "urh_tpu"
    for module in (settings, jax_settings):
        monkeypatch.setattr(module, "_config_dir", str(folder))
        monkeypatch.setattr(module, "_settings_file", str(folder / "settings.json"))
        monkeypatch.setattr(module, "_store", None)
    return folder


# -- the undo stack --------------------------------------------------------------------


def _inc(base, state):
    """An undo command of either package's base class that counts into state."""

    class Inc(base):
        def __init__(self):
            super().__init__("inc")

        def redo(self):
            state[0] += 1

        def undo(self):
            state[0] -= 1

    return Inc()


def _stack_trace(package):
    stack, state, events = package.UndoStack(), [0], []
    stack.index_changed.connect(lambda i: events.append(("index", i)))
    stack.clean_changed.connect(lambda c: events.append(("clean", c)))
    trace = []
    for op in ("push", "push", "undo", "set_clean", "push", "undo", "undo", "redo", "redo",
               "redo", "undo", "undo", "undo", "push", "clear", "push"):
        if op == "push":
            stack.push(_inc(package.UndoCommand, state))
        else:
            getattr(stack, op)()
        trace.append((op, state[0], stack.index, stack.count, stack.can_undo(),
                      stack.can_redo(), stack.is_clean(), stack.undo_text, stack.redo_text))
    return trace, events


def test_undo_stack_semantics_equal_urh_tpu():
    got, want = _stack_trace(undo), _stack_trace(jax_undo)
    assert got == want
    trace = got[0]
    assert trace[1][1] == 2 and trace[2][1] == 1 and trace[4][1:4] == (2, 2, 2)
    assert trace[4][5] is False  # a push discards the redo tail


# -- signal edits and their undo -------------------------------------------------------------


def _capture(kind: str, seed: int, n_msgs: int = 4, n_bits: int = 48, pause: int = 4000):
    rng = np.random.default_rng(seed)
    parts = [np.zeros((2000, 2), np.float32)]
    for _ in range(n_msgs):
        bits = rng.integers(0, 2, n_bits)
        bits[0] = bits[-1] = 1
        if kind == "FSK":
            parts.append(jax_modulate(bits, 100, "fsk", [-20e3, 20e3], carrier_frequency=0.0,
                                      pause=pause))
        else:
            parts.append(jax_modulate(bits, 100, "ask", [0.0, 1.0], carrier_frequency=10e3,
                                      pause=pause))
    iq = np.concatenate(parts)
    return (iq + rng.normal(0, 0.01, iq.shape)).astype(np.float32)


PARAMS = {"FSK": dict(modulation="FSK", samples_per_symbol=100, center=0.0,
                      noise_threshold=0.1, tolerance=5),
          "ASK": dict(modulation="ASK", samples_per_symbol=100, center=0.25,
                      noise_threshold=0.1, tolerance=5, pause_threshold=20)}


class _Pair:
    """The same signal and protocol in both packages, demodulated."""

    def __init__(self, kind: str, seed: int = 1, dtype=np.float32):
        iq = _capture(kind, seed)
        if dtype == np.int8:
            iq = np.clip(np.round(iq * 127), -128, 127).astype(np.int8)
        params = dict(PARAMS[kind])
        if dtype == np.int8:
            params["noise_threshold"] *= 127
        self.sig = ut.Signal.from_iq(iq.copy(), device="cpu")
        self.sig.params = ut.DemodParams(**params)
        self.jax_sig = jax_ut.Signal.from_iq(iq.copy())
        self.jax_sig.params = jax_ut.DemodParams(**params)
        self.proto, self.jax_proto = ProtocolAnalyzer(self.sig), JaxProtocolAnalyzer(self.jax_sig)
        self.proto.get_protocol_from_signal()
        self.jax_proto.get_protocol_from_signal()
        self.stack, self.jax_stack = undo.UndoStack(), jax_undo.UndoStack()
        self.original = iq.copy()

    def push(self, mode: str, **kwargs):
        jax_kwargs = dict(kwargs)
        if "dsp_filter" in kwargs:
            jax_kwargs["dsp_filter"] = JaxFilter(kwargs["dsp_filter"].taps)
        self.stack.push(actions.EditSignalAction(self.sig, getattr(actions.EditAction, mode),
                                                 protocol=self.proto, **kwargs))
        self.jax_stack.push(jax_actions.EditSignalAction(
            self.jax_sig, getattr(jax_actions.EditAction, mode), protocol=self.jax_proto,
            **jax_kwargs))

    def undo(self):
        self.stack.undo()
        self.jax_stack.undo()

    def assert_equal(self, atol: float = 0.0):
        got, want = self.sig.iq_array.data, self.jax_sig.iq_array.data
        assert got.shape == want.shape and got.dtype == want.dtype
        if atol:
            assert np.abs(got.astype(np.float64) - want).max() <= atol
        else:
            assert np.array_equal(got, want)
        assert self.messages() == [(m.plain_bits_str, m.participant and m.participant.name,
                                    m.pause) for m in self.jax_proto.messages]
        # the next demodulation from the samples as they are now agrees too
        assert [m.plain_bits_str for m in ut.demodulate(self.sig)] == [
            m.plain_bits_str for m in jax_ut.demodulate(self.jax_sig)]

    def messages(self):
        return [(m.plain_bits_str, m.participant and m.participant.name, m.pause)
                for m in self.proto.messages]

    def message_range(self, i: int):
        """The samples of message i's bits (bit_sample_pos[-1] is where its
        pause ends)."""
        pos = self.proto.messages[i].bit_sample_pos
        return int(pos[0]), int(pos[-2])


def _tag(pair):
    """Give the second message a participant in both packages."""
    pair.proto.messages[1].participant = labels.Participant("Alice", "A")
    pair.jax_proto.messages[1].participant = jax_labels.Participant("Alice", "A")


def _edits(pair):
    n = pair.sig.num_samples
    start, end = pair.message_range(0)
    second = pair.message_range(1)
    pause = (second[1] + pair.message_range(2)[0]) // 2
    sine = InsertSinePlugin()
    sine.num_samples, sine.frequency = 3000, 20e3
    return [("crop", dict(start=start - 500, end=n - 1000)),
            ("crop", dict(start=second[0] - 10, end=second[1] + 10)),
            ("mute", dict(start=start - 10, end=end + 10)),
            ("mute", dict(start=100, end=1500)),
            ("delete", dict(start=start - 10, end=end + 10)),
            ("delete", dict(start=pause, end=pause + 200)),
            ("paste", dict(position=pause, data_to_insert=pair.original[start:end + 100])),
            ("insert", dict(position=pause, data_to_insert=sine.generate_sine_wave(
                pair.sig.iq_array.dtype))),
            ("filter", dict(start=0, end=n, dsp_filter=Filter(
                Filter.design_windowed_sinc_bandpass(*BANDPASS))))]


@pytest.mark.parametrize("kind", ["FSK", "ASK"])
@pytest.mark.parametrize("step", range(9))
def test_edit_and_undo_equal_urh_tpu(kind, step):
    pair = _Pair(kind)
    _tag(pair)
    before = pair.messages()
    assert len(before) == 4
    mode, kwargs = _edits(pair)[step]
    pair.push(mode, **kwargs)
    pair.assert_equal(FILTER_ATOL if mode == "filter" else 0.0)
    if mode == "mute" and kwargs["start"] > 1000:
        # a muted ASK message is silence; a muted FSK one zero frequency,
        # which decodes as zeros
        if kind == "ASK":
            assert pair.messages() == before[1:]
        else:
            # the metadata moves as urh_tpu moves it: by the messages removed
            assert [m[0] for m in pair.messages()] == ["0" * 48] + [m[0] for m in before[1:]]
    pair.undo()
    pair.assert_equal()
    assert np.array_equal(pair.sig.iq_array.data, pair.original)
    assert pair.messages() == before
    pair.stack.redo()
    pair.jax_stack.redo()
    pair.assert_equal(FILTER_ATOL if mode == "filter" else 0.0)


def test_edits_stacked_then_undone_in_order():
    pair = _Pair("FSK", seed=2)
    snapshots = [(pair.sig.iq_array.data.copy(), pair.messages())]
    for mode, kwargs in _edits(pair)[2:8]:
        pair.push(mode, **kwargs)
        pair.assert_equal()
        snapshots.append((pair.sig.iq_array.data.copy(), pair.messages()))
    for data, messages in reversed(snapshots[:-1]):
        pair.undo()
        pair.assert_equal()
        assert np.array_equal(pair.sig.iq_array.data, data) and pair.messages() == messages


def test_int8_mute_demodulates_the_muted_samples_where_urh_tpu_decodes_a_zeroed_qad():
    """ROADMAP C11: an int8 capture's states come from K2 with no qad
    cached, so the port's mute demodulates the muted samples again: the
    message goes, as a fresh signal of those samples gives it in both
    packages.  urh_tpu's host route caches qad and decodes the zeroed range
    as a message of zeros (its TPU route, like the port,
    caches no qad for int8)."""
    pair = _Pair("FSK", seed=3, dtype=np.int8)
    before = pair.messages()
    start, end = pair.message_range(0)
    pair.push("mute", start=start - 10, end=end + 10)
    assert np.array_equal(pair.sig.iq_array.data, pair.jax_sig.iq_array.data)
    fresh = jax_ut.Signal.from_iq(pair.sig.iq_array.data.copy())
    fresh.params = pair.jax_sig.params
    got = [m for m, _, _ in pair.messages()]
    assert got == [m.plain_bits_str for m in jax_ut.demodulate(fresh)]
    assert got == [m for m, _, _ in before[1:]]
    jax_got = [m.plain_bits_str for m in pair.jax_proto.messages]
    assert len(jax_got) == 4 and set(jax_got[0]) == {"0"} and jax_got[1:] == got
    pair.undo()
    pair.assert_equal()
    assert pair.messages() == before


def test_int8_filter_equals_urh_tpu():
    pair = _Pair("FSK", seed=3, dtype=np.int8)
    pair.push("filter", start=0, end=pair.sig.num_samples,
              dsp_filter=Filter(Filter.design_windowed_sinc_bandpass(*BANDPASS)))
    pair.assert_equal(1)  # a float on an integer boundary may truncate either way
    pair.undo()
    assert np.array_equal(pair.sig.iq_array.data, pair.original)


def test_mute_with_qad_cached_drops_the_fused_states():
    """The port's fused kernels cache states beside qad.  A mute zeroes the
    range of qad and drops the states (as filter_range does), so the muted
    message goes, as urh_tpu's host route has it; urh_tpu's TPU route would
    keep the stale states and the message (ROADMAP C11)."""
    sig = ut.Signal.from_iq(_capture("FSK", 4), device="cpu")
    sig.params = ut.DemodParams(**PARAMS["FSK"])
    sig.qad
    assert sig.qad_states is not None
    proto = ProtocolAnalyzer(sig)
    proto.get_protocol_from_signal()
    pos = proto.messages[0].bit_sample_pos
    sig.mute_range(int(pos[0]) - 10, int(pos[-1]) + 10)
    assert sig.qad_states is None and sig._qad is not None
    assert len(ut.demodulate(sig)) == 3


def test_change_signal_parameter_equals_urh_tpu_and_keeps_no_tensor():
    pair = _Pair("ASK", seed=5)
    _tag(pair)
    before = pair.messages()
    for package_actions, sig, proto, stack in (
            (actions, pair.sig, pair.proto, pair.stack),
            (jax_actions, pair.jax_sig, pair.jax_proto, pair.jax_stack)):
        stack.push(package_actions.ChangeSignalParameter(sig, proto, "samples_per_symbol", 50))
    assert pair.stack.undo_text == pair.jax_stack.undo_text
    assert pair.sig.samples_per_symbol == 50
    pair.assert_equal()
    assert pair.messages() != before
    command = pair.stack.command(0)
    _assert_no_tensor(command.orig_messages)
    _assert_no_tensor(vars(pair.stack.command(0)))
    pair.undo()
    assert pair.sig.samples_per_symbol == 100 and pair.messages() == before
    pair.assert_equal()
    with pytest.raises(ValueError):
        actions.ChangeSignalParameter(pair.sig, pair.proto, "no_such_parameter", 1)


def _assert_no_tensor(obj, seen=None):
    """No torch tensor in obj or anything it holds, signals aside."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, (ut.Signal, str, bytes, int, float)):
        return
    seen.add(id(obj))
    assert not isinstance(obj, torch.Tensor)
    if isinstance(obj, dict):
        for k, v in obj.items():
            _assert_no_tensor(k, seen)
            _assert_no_tensor(v, seen)
    elif isinstance(obj, (list, tuple, set)):
        for v in obj:
            _assert_no_tensor(v, seen)
    elif hasattr(obj, "__dict__"):
        _assert_no_tensor(vars(obj), seen)


def test_edit_actions_keep_host_data_only():
    pair = _Pair("FSK", seed=6)
    for mode, kwargs in _edits(pair):
        pair.push(mode, **kwargs)
        command = pair.stack.command(pair.stack.index - 1)
        _assert_no_tensor({k: v for k, v in vars(command).items()
                           if k not in ("protocol", "signal")})
        pair.undo()
    assert pair.stack.count == 1 and np.array_equal(pair.sig.iq_array.data, pair.original)


# -- table-level actions ------------------------------------------------------------------


def _protos(strings):
    proto, jax_proto = ProtocolAnalyzer(None), JaxProtocolAnalyzer(None)
    for s in strings:
        proto.messages.append(Message.from_plain_bits_str(s))
        jax_proto.messages.append(JaxMessage.from_plain_bits_str(s))
    for p in (proto, jax_proto):
        for msg in p.messages:
            msg.message_type = p.default_message_type
    return proto, jax_proto


def _bits(proto):
    return [m.plain_bits_str for m in proto.messages]


@pytest.mark.parametrize("index,rows,view", [(2, [0, 1], 0), (1, [1], 1), (0, [0, 2], 2),
                                             (7, [2], 0)])
def test_insert_column_equals_urh_tpu(index, rows, view):
    proto, jax_proto = _protos(["1111000011110000", "0000", "1010101010101010"])
    cmd = actions.InsertColumn(proto, index, rows, view=view)
    jax_cmd = jax_actions.InsertColumn(jax_proto, index, rows, view=view)
    cmd.redo()
    jax_cmd.redo()
    assert _bits(proto) == _bits(jax_proto) and cmd.text == jax_cmd.text
    cmd.undo()
    jax_cmd.undo()
    assert _bits(proto) == _bits(jax_proto) == ["1111000011110000", "0000", "1010101010101010"]


@pytest.mark.parametrize("span", [(0, 0, 0, 3), (0, 1, 2, 5), (1, 2, 0, 100), (0, 2, 1, 1)])
def test_delete_bits_and_pauses_equal_urh_tpu(span):
    strings = ["11110000", "00001111", "10101010"]
    proto, jax_proto = _protos(strings)
    model, jax_model = models.ProtocolTableModel(proto), jax_models.ProtocolTableModel(jax_proto)
    model.update()
    jax_model.update()
    model.delete_range(*span)
    jax_model.delete_range(*span)
    assert _bits(proto) == _bits(jax_proto)
    assert model.row_count == jax_model.row_count
    model.undo_stack.undo()
    jax_model.undo_stack.undo()
    assert _bits(proto) == _bits(jax_proto) == strings


def _generators():
    return models.GeneratorTableModel(), jax_models.GeneratorTableModel()


def test_generator_fuzz_clear_insert_equal_urh_tpu(config):
    model, jax_model = _generators()
    source, jax_source = _protos(["101010101111", "110011"])
    model.insert_protocol(source)
    jax_model.insert_protocol(jax_source)
    for m in (model, jax_model):
        msg = m.protocol.messages[0]
        lbl = msg.message_type.add_protocol_label(4, 7)
        lbl.fuzz_me = True
        lbl.fuzz_values = ["1010", "0000", "0001", "0010"]
    for mode in ("successive", "Concurrent", "exhaustive"):
        model.fuzz(mode)
        jax_model.fuzz(mode)
        assert _bits(model.protocol) == _bits(jax_model.protocol)
        assert [m.pause for m in model.protocol.messages] == [
            m.pause for m in jax_model.protocol.messages]
        assert model.refresh_fonts().keys() == jax_model.refresh_fonts().keys()
        model.undo_stack.undo()
        jax_model.undo_stack.undo()
        assert _bits(model.protocol) == ["101010101111", "110011"]
    with pytest.raises(ValueError):
        actions.Fuzz(model.protocol, "sideways").redo()
    model.clear()
    jax_model.clear()
    assert _bits(model.protocol) == _bits(jax_model.protocol) == []
    model.undo_stack.undo()
    assert _bits(model.protocol) == ["101010101111", "110011"]
    model.duplicate_rows([1])
    model.add_empty_row_behind(0, 8)
    jax_model.undo_stack.undo()
    jax_model.duplicate_rows([1])
    jax_model.add_empty_row_behind(0, 8)
    assert _bits(model.protocol) == _bits(jax_model.protocol)
    assert model.protocol.messages[1].pause == jax_model.protocol.messages[1].pause


# -- table models ----------------------------------------------------------------------


def _views(model):
    out = []
    for view in (0, 1, 2):
        model.proto_view = view
        out.append((model.row_count, model.col_count,
                    [model.row_text(r) for r in range(model.row_count)],
                    [model.data(r, c) for r in range(model.row_count)
                     for c in range(model.col_count + 1)],
                    dict(model.diffs), dict(model.vertical_header_text)))
    return out


def test_protocol_table_model_views_and_diffs_equal_urh_tpu():
    strings = ["10100101", "10101111", "1010010111110000", "0110"]
    proto, jax_proto = _protos(strings)
    proto.messages[2].participant = labels.Participant("Bob", "B")
    jax_proto.messages[2].participant = jax_labels.Participant("Bob", "B")
    proto.messages[3].alignment_offset = jax_proto.messages[3].alignment_offset = 4
    model = models.ProtocolTableModel(proto)
    jax_model = jax_models.ProtocolTableModel(jax_proto)
    for m in (model, jax_model):
        m.update()
    assert _views(model) == _views(jax_model)
    for m in (model, jax_model):
        m.refindex = 0
    assert _views(model) == _views(jax_model)
    model.proto_view = jax_model.proto_view = 1
    assert model.diffs[1] == {1}
    model.hidden_rows = {2}
    jax_model.hidden_rows = {2}
    assert _views(model) == _views(jax_model)


@pytest.mark.parametrize("view,value", [(0, "0101"), (0, "1"), (1, "a"), (1, "F0"), (2, "x")])
def test_protocol_table_model_search_equals_urh_tpu(view, value):
    proto, jax_proto = _protos(["10100101", "00101000", "0101010101111000"])
    model = models.ProtocolTableModel(proto)
    jax_model = jax_models.ProtocolTableModel(jax_proto)
    for m in (model, jax_model):
        m.proto_view = view
        m.update()
    assert model.find_protocol_value(value) == jax_model.find_protocol_value(value)
    assert model.search_results == jax_model.search_results


def test_label_index_and_participants():
    proto, jax_proto = _protos(["1010101011110000"])
    for p in (proto, jax_proto):
        p.default_message_type.add_protocol_label(4, 7, name="a")
        p.default_message_type.add_protocol_label(8, 15, name="b")
    model = models.ProtocolTableModel(proto)
    jax_model = jax_models.ProtocolTableModel(jax_proto)
    for col in range(17):
        assert model.get_selected_label_index(0, col) == jax_model.get_selected_label_index(
            0, col)
    assert model.get_selected_label_index(5, 0) == -1
    alice = labels.Participant("Alice", "A")
    proto.messages[0].participant = alice
    model.participants = [alice]
    assert proto.messages[0].participant is alice
    model.participants = []
    assert proto.messages[0].participant is None


@pytest.mark.parametrize("edits", [[(0, 2, "0")], [(0, 2, "0"), ("view", 1), (0, 2, "f")],
                                   [("view", 2), (0, 1, "A")], [(0, 0, "x")],
                                   [("view", 1), (0, 0, "g")]])
def test_generator_editing_and_padding_equal_urh_tpu(edits):
    model, jax_model = _generators()
    for m, msg_cls in ((model, Message), (jax_model, JaxMessage)):
        m.protocol.messages.append(msg_cls.from_plain_bits_str("1010"))
        m.update()
    for edit in edits:
        if edit[0] == "view":
            model.proto_view = jax_model.proto_view = edit[1]
            continue
        assert model.set_data(*edit) == jax_model.set_data(*edit)
        assert _bits(model.protocol) == _bits(jax_model.protocol)
    assert _views(model) == _views(jax_model)


def test_read_only_table_refuses_edits():
    proto, _ = _protos(["1010"])
    model = models.ProtocolTableModel(proto)
    model.update()
    assert not model.set_data(0, 0, "0") and _bits(proto) == ["1010"]


# -- label, fuzzing, participant, message-type and ruleset models ----------------------


def _checksum_protos(payload: str):
    out = []
    for lab, proto in zip((labels, jax_labels), _protos([payload])):
        ft = lab.FieldType("checksum", lab.FieldType.Function.CHECKSUM)
        mt = proto.default_message_type
        mt.append(lab.ChecksumLabel("checksum", 8, 15, 0, field_type=ft))
        mt.add_protocol_label(0, 7, name="data")
        proto.messages[0].message_type = mt
        out.append(proto)
    return out


@pytest.mark.parametrize("payload", ["1010101011111111", "0000000100000111", "1111111100000000"])
def test_label_value_model_equals_urh_tpu(payload):
    proto, jax_proto = _checksum_protos(payload)
    model, jax_model = models.LabelValueTableModel(proto), jax_models.LabelValueTableModel(
        jax_proto)
    assert model.rows() == jax_model.rows()
    for lbl, jax_lbl in zip(model.display_labels, jax_model.display_labels):
        for fmt in range(4):
            for order in range(3):
                lbl.display_format_index = jax_lbl.display_format_index = fmt
                lbl.display_bit_order_index = jax_lbl.display_bit_order_index = order
                assert model.rows() == jax_model.rows()
    model.show_label_values = jax_model.show_label_values = False
    assert model.rows() == jax_model.rows()
    model.message_index = jax_model.message_index = 5
    assert model.message is None and model.rows() == jax_model.rows()


def test_checksum_status_of_a_valid_crc():
    proto, jax_proto = _checksum_protos("1010101000000000")
    lbl = next(x for x in proto.default_message_type if isinstance(x, labels.ChecksumLabel))
    crc = lbl.calculate_checksum_for_message(proto.messages[0], use_decoded_bits=True)
    bits = "10101010" + "".join(str(int(b)) for b in crc)
    proto, jax_proto = _checksum_protos(bits)
    got = models.LabelValueTableModel(proto).rows()
    assert got == jax_models.LabelValueTableModel(jax_proto).rows()
    assert [row["checksum_ok"] for row in got if row["name"] == "checksum"] == [True]


@pytest.mark.parametrize("message", [False, True])
def test_plabel_model_equals_urh_tpu(message):
    out = []
    for lab, msg_cls, package in ((labels, Message, models), (jax_labels, JaxMessage,
                                                               jax_models)):
        mt = lab.MessageType("t")
        lbl = mt.add_protocol_label(0, 7, name="preamble")
        mt.add_protocol_label(8, 15, name="sync")
        field = lab.FieldType("sync", lab.FieldType.Function.SYNC)
        msg = msg_cls.from_plain_bits_str("1" * 24) if message else None
        if msg is not None:
            msg.message_type = mt
        model = package.PLabelTableModel(mt, field_types=[field], message=msg)
        model.proto_view = 1 if message else 0
        rows = [model.row(i) for i in range(model.row_count)]
        edits = [model.set_field(0, "start", 2), model.set_field(0, "end", 3),
                 model.set_field(0, "name", "sync"), model.set_field(1, "name", ""),
                 model.set_field(1, "color_index", 4),
                 model.set_field(1, "apply_decoding", False), model.set_field(1, "bogus", 1)]
        after = [model.row(i) for i in range(model.row_count)]
        out.append((rows, edits, after, (lbl.start, lbl.end),
                    lbl.field_type and lbl.field_type.caption,
                    model.remove_label_at(0) is lbl, len(mt)))
    assert out[0] == out[1]


def test_fuzzing_table_model_equals_urh_tpu():
    out = []
    for lab, package in ((labels, models), (jax_labels, jax_models)):
        mt = lab.MessageType("t")
        lbl = mt.add_protocol_label(0, 7, name="data")
        lbl.fuzz_values = ["00000000"]
        model = package.FuzzingTableModel(lbl)
        model.add_range(1, 4)
        model.add_boundaries(0, 255, 2)
        model.add_random(5, 3, 1000, seed=7)
        model.repeat_fuzzing_values(0, 2, 2)
        model.remove_duplicates = False
        model.repeat_fuzzing_values(1, 3, 1)
        model.set_bit(0, 3, "1")
        model.remove_rows([2, 4])
        views = []
        for view in (0, 1, 2):
            model.proto_view = view
            views.append((model.row_count, model.col_count,
                          [model.data(i, j) for i in range(model.row_count)
                           for j in range(model.col_count)], model.set_bit(0, 0, "1")))
        out.append((list(lbl.fuzz_values), views))
    assert out[0] == out[1]


def test_participant_message_type_and_ruleset_models_equal_urh_tpu():
    out = []
    for lab, package in ((labels, models), (jax_labels, jax_models)):
        people = [lab.Participant("Alice", "A"), lab.Participant("Bob", "B")]
        plist = package.ParticipantListModel(people)
        shown = []
        plist.show_state_changed.connect(lambda: shown.append(True))
        plist.set_shown(1, False)
        plist.set_shown(1, False)
        mts = [lab.MessageType("one"), lab.MessageType("two")]
        rule = lab.Rule(start=0, end=8, operator="=", target_value="aa", value_type=1)
        mts[1].ruleset = lab.Ruleset(rules=[rule])
        mtable = package.MessageTypeTableModel(mts)
        visible, names = [], []
        mtable.message_type_visibility_changed.connect(lambda mt: visible.append(mt.name))
        mtable.message_type_name_edited.connect(names.append)
        mtable.set_shown(0, False)
        mtable.set_name(1, "renamed")
        mtable.set_name(0, "")
        rules = package.RulesetTableModel(mts[1].ruleset)
        out.append(([plist.text(i) for i in range(plist.row_count)], len(shown),
                    [mtable.row(i) for i in range(mtable.row_count)], visible, names,
                    [rules.row(i) for i in range(rules.row_count)]))
    assert out[0] == out[1]


def test_protocol_tree_model_equals_urh_tpu():
    out = []
    for package, analyzer in ((models, ProtocolAnalyzer), (jax_models, JaxProtocolAnalyzer)):
        tree = package.ProtocolTreeModel()
        events = []
        tree.group_deleted.connect(lambda a, b: events.append(("deleted", a, b)))
        tree.proto_to_group_added.connect(lambda g: events.append(("added", g)))
        p1, p2, p3 = (analyzer(None, filename=f"p{i}") for i in range(3))
        tree.add_protocol(p1)
        tree.add_group("Second")
        item2 = tree.add_protocol(p2, 1)
        tree.add_protocol(p3, 5)
        tree.move_to_group([item2], 0)
        names = [[c.name for c in g.children] for g in tree.groups]
        removed = tree.remove_protocol(p3), tree.remove_protocol(p3)
        tree.delete_group(1)
        with pytest.raises(ValueError):
            tree.delete_group(0)
        item2.copy_data = True
        copied = item2.protocol is not p2 and item2.protocol.name == p2.name
        out.append((names, removed, events, tree.ngroups, [p.name for p in tree.protocol_list],
                    tree.group_at(0).name, item2.index_in_parent(), copied))
    assert out[0] == out[1]


def test_simulator_message_models_equal_urh_tpu():
    from urh_tpu.sim import configuration as jax_configuration
    from urh_tpu.sim import items as jax_items
    from urh_tpu_torch.sim import configuration, items

    out = []
    from urh_tpu.util.project import ProjectManager as JaxProjectManager
    from urh_tpu_torch.util.project import ProjectManager

    for package, cfg_mod, item_mod, lab, pm in (
            (models, configuration, items, labels, ProjectManager),
            (jax_models, jax_configuration, jax_items, jax_labels, JaxProjectManager)):
        config = cfg_mod.SimulatorConfiguration(pm())
        msg = item_mod.SimulatorMessage(destination=None, plain_bits=[1, 0, 1, 1] * 8,
                                        pause=100, message_type=lab.MessageType("m"))
        config.add_items([msg], 0, None)
        specs = ((0, 7, 0, {}), (8, 15, 2, dict(formula="item1.seq + 1")),
                 (16, 23, 3, dict(external_program="echo")),
                 (24, 31, 4, dict(random_min=1, random_max=9)))
        for start, end, kind, attrs in specs:
            lbl = item_mod.SimulatorProtocolLabel(lab.ProtocolLabel("f", start, end, 0))
            lbl.value_type_index = kind
            for key, value in attrs.items():
                setattr(lbl, key, value)
            msg.message_type.append(lbl)
        table = package.SimulatorMessageTableModel(config)
        table.update()
        field_model = package.SimulatorMessageFieldModel()
        field_model.message = msg
        out.append((table.row_count, table.col_count, table.row_text(0),
                    [field_model.row(i) for i in range(field_model.row_count)]))
    assert out[0] == out[1]


def test_file_proxy_model_equals_urh_tpu(tmp_path):
    model, jax_model = models.FileProxyModel(), jax_models.FileProxyModel()
    assert model.extensions == jax_model.extensions
    for name in ("a.complex", "b.wav", "c.txt", "d.sub", "e.coco", "f.cs8"):
        path = tmp_path / name
        path.write_bytes(b"")
        assert model.accept(str(path)) == jax_model.accept(str(path))
    assert model.accept(str(tmp_path))


# -- widget controllers ------------------------------------------------------------------


def _checksum_controllers(message: bool, proto_view: int = 0):
    out = []
    for lab, package, msg_cls in ((labels, widgets, Message),
                                  (jax_labels, jax_widgets, JaxMessage)):
        lbl = lab.ChecksumLabel("checksum_label", 50, 100, 0,
                                lab.FieldType("crc", lab.FieldType.Function.CHECKSUM))
        msg = msg_cls([0] * 150, 0, lab.MessageType("test")) if message else None
        out.append(package.ChecksumWidgetController(lbl, msg, proto_view))
    return out


@pytest.mark.parametrize("proto_view", [0, 1])
def test_checksum_widget_controller_equals_urh_tpu(proto_view):
    ctrl, jax_ctrl = _checksum_controllers(True, proto_view)

    def state(c):
        return (c.row_count, [c.range_at(i) for i in range(c.row_count)], c.polynomial_hex,
                c.start_value_hex, c.final_xor_hex, c.category, c.categories,
                c.crc_function_names)

    assert state(ctrl) == state(jax_ctrl)
    for c in (ctrl, jax_ctrl):
        c.add_range()
        c.set_range(1, start=3, end=9)
        c.add_range()
        c.remove_range()
        c.set_crc_function(2)
        c.set_polynomial_from_hex("abcde")
    assert state(ctrl) == state(jax_ctrl)
    for c in (ctrl, jax_ctrl):
        c.set_crc_function("CC1101")
        c.remove_range()
        c.remove_range()
    assert state(ctrl) == state(jax_ctrl) and ctrl.row_count == 1
    for c in (ctrl, jax_ctrl):
        c.set_wsp_mode("crc8")
    assert (ctrl.category, ctrl.checksum_label.checksum.mode.name) == (
        jax_ctrl.category, jax_ctrl.checksum_label.checksum.mode.name) == (
        "Wireless Short Packet (WSP)", "crc8")
    ctrl.set_category("generic")
    assert ctrl.category == "generic"


def test_filter_bandwidth_controller_equals_urh_tpu(config):
    ctrl, jax_ctrl = widgets.FilterBandwidthController(), jax_widgets.FilterBandwidthController()
    assert (ctrl.custom_bandwidth, ctrl.bandwidth_type, ctrl.kernel_length_by_name) == (
        jax_ctrl.custom_bandwidth, jax_ctrl.bandwidth_type, jax_ctrl.kernel_length_by_name)
    ctrl.custom_kernel_length = jax_ctrl.custom_kernel_length = 401
    assert ctrl.custom_bandwidth == jax_ctrl.custom_bandwidth
    ctrl.custom_bandwidth = 0.3
    assert ctrl.custom_kernel_length == Filter.get_filter_length_from_bandwidth(0.3)
    ctrl.bandwidth_type = "Wide"
    ctrl.save()
    jax_settings._store = None
    again = jax_widgets.FilterBandwidthController()
    assert (again.custom_bandwidth, again.bandwidth_type) == (0.3, "Wide")
    settings._store = None
    assert widgets.FilterBandwidthController().custom_bandwidth == 0.3


def test_costas_options_and_bit2hex():
    ctrl = widgets.CostaOptionsController(0.1)
    ctrl.set_bandwidth("0.2")
    assert ctrl.costas_loop_bandwidth == 0.2
    for bits in ([1, 0, 1, 0, 1, 1, 1, 1], [0] * 12, [1]):
        assert widgets.bit2hex(bits) == jax_widgets.bit2hex(bits)


# -- PNG and waveform bitmaps ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (40, 33)])
def test_png_bytes_equal_urh_tpu(shape):
    image = np.random.default_rng(8).integers(0, 256, shape + (4,), dtype=np.uint8)
    assert png.encode_rgba(image) == jax_png.encode_rgba(image)
    assert png.encode_bgra(image) == jax_png.encode_bgra(image)
    with pytest.raises(ValueError):
        png.encode_rgba(image[..., :3])


@pytest.mark.parametrize("n,width,height", [(0, 600, 120), (1, 10, 5), (7, 600, 120),
                                            (5000, 600, 120), (123457, 97, 31)])
def test_waveform_bitmap_equals_urh_tpu(n, width, height):
    y = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got = plots.render_waveform_rgba(y, width, height)
    assert np.array_equal(got, jax_plots.render_waveform_rgba(y, width, height))
    assert png.encode_rgba(got) == jax_png.encode_rgba(got)


def test_plots_write_files(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    from urh_tpu_torch.util import colormaps

    # plot_spectrogram chooses its colormap for the process: put it back after
    for name in ("chosen_colormap_name", "chosen_colormap_numpy_bgra"):
        monkeypatch.setattr(colormaps, name, getattr(colormaps, name))
    sig = ut.Signal.from_iq(_capture("FSK", 9), device="cpu")
    sig.params = ut.DemodParams(**PARAMS["FSK"])
    for show_qad in (False, True):
        path = tmp_path / f"signal_{show_qad}.png"
        assert plots.plot_signal(sig, str(path), show_qad=show_qad) == str(path)
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    path = tmp_path / "spectrogram.png"
    plots.plot_spectrogram(sig.iq_array.as_complex64(), str(path), window_size=256,
                           device="cpu")
    assert path.stat().st_size > 0
    path = tmp_path / "messages.png"
    plots.plot_messages(ut.demodulate(sig), str(path), view=1)
    assert path.stat().st_size > 0


def test_insert_sine_plugin_through_the_undo_stack():
    pair = _Pair("ASK", seed=10)
    start, end = pair.message_range(1)
    sine, jax_sine = InsertSinePlugin(), JaxInsertSinePlugin()
    for p in (sine, jax_sine):
        p.num_samples, p.frequency, p.amplitude = 2500, 15e3, 0.4
    wave = sine.generate_sine_wave(pair.sig.iq_array.dtype)
    assert np.array_equal(wave, jax_sine.generate_sine_wave(pair.jax_sig.iq_array.dtype))
    pair.push("insert", position=end + 1000, data_to_insert=wave)
    pair.assert_equal()
    assert pair.sig.num_samples == len(pair.original) + 2500
    pair.undo()
    assert np.array_equal(pair.sig.iq_array.data, pair.original)
    pair.assert_equal()
    assert copy.deepcopy(pair.messages()) == pair.messages()
