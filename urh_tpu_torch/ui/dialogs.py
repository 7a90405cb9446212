"""Headless dialog controllers (PyTorch port of urh_tpu.ui.dialogs; host
logic, no tensors).

Counterparts of the reference's controller/dialogs/*.py, re-designed
without Qt: each controller holds the same state and implements the same
accept/reject/edit behaviors as the reference dialog, exposing plain
properties and Event hooks instead of widgets. Citations point at the
reference implementation each controller mirrors.
"""

from __future__ import annotations

import copy
import math
import os
import time

from urh_tpu_torch.protocol.labels import (ChecksumLabel, FieldType, MessageType,
                                           Mode, ProtocolLabel, Rule,
                                           OPERATION_DESCRIPTION)
from urh_tpu_torch.ui.models import FuzzingTableModel, PLabelTableModel, RulesetTableModel
from urh_tpu_torch.ui.widgets import ChecksumWidgetController
from urh_tpu_torch.util.events import Event
from urh_tpu_torch.util.formatter import Formatter

VIEW_BIT, VIEW_HEX, VIEW_ASCII = 0, 1, 2


class ProtocolLabelDialogController:
    """Edit the labels of one message's message type
    (dialogs/ProtocolLabelDialog.py:22-167): a PLabelTableModel over the
    message type plus one checksum-configuration tab per CHECKSUM label."""

    SPECIAL_CONFIG_TYPES = [FieldType.Function.CHECKSUM]

    def __init__(self, message, view_type: int = VIEW_BIT, field_types=None):
        self.message = message
        self.proto_view = view_type
        field_types = (field_types if field_types is not None
                       else FieldType.default_field_types())
        self.model = PLabelTableModel(message.message_type, field_types,
                                      message=message)
        self.apply_decoding_changed = Event(object, object)
        self.checksum_widgets = []
        self.configure_special_config_tabs()

    @property
    def message_type(self) -> MessageType:
        return self.model.message_type

    def configure_special_config_tabs(self):
        """One ChecksumWidgetController per checksum-typed label
        (ProtocolLabelDialog.py:99-124)."""
        self.checksum_widgets = [
            ChecksumWidgetController(lbl, self.message, self.proto_view)
            for lbl in self.message_type
            if isinstance(lbl, ChecksumLabel) and lbl.field_type is not None
            and lbl.field_type.function in self.SPECIAL_CONFIG_TYPES]

    def set_view_index(self, view: int):
        """ProtocolLabelDialog.py:154-160: switch bit/hex/ascii view on the
        label table and every checksum tab."""
        self.proto_view = view
        self.model.proto_view = view
        for w in self.checksum_widgets:
            w.proto_view = view

    def set_label_name(self, row: int, name: str):
        """Renaming to a known field-type caption retypes the label
        (PLabelTableModel semantics); checksum status changes rebuild the
        special config tabs (ProtocolLabelDialog.py:165-167)."""
        self.model.set_field(row, "name", name)
        self.configure_special_config_tabs()

    def remove_label(self, row: int):
        lbl = self.model.remove_label_at(row)
        self.configure_special_config_tabs()
        return lbl

    def set_apply_decoding(self, row: int, value: bool):
        """Toggling apply-decoding notifies the analysis controller so it can
        re-decode affected messages (ProtocolLabelDialog.py:161-163)."""
        lbl = self.model.label_at(row)
        if lbl.apply_decoding != bool(value):
            self.model.set_field(row, "apply_decoding", value)
            self.apply_decoding_changed.emit(lbl, self.message_type)


class MessageTypeDialogController:
    """Edit a message type's assignment ruleset
    (dialogs/MessageTypeDialog.py:16-132). Rejecting restores the deep-copied
    original ruleset and assignment mode (:29-30,:100-104)."""

    def __init__(self, message_type: MessageType):
        self.message_type = message_type
        self.original_ruleset = copy.deepcopy(message_type.ruleset)
        self.original_assigned_status = message_type.assigned_by_ruleset
        operator_descriptions = sorted(OPERATION_DESCRIPTION.values())
        self.ruleset_table_model = RulesetTableModel(
            message_type.ruleset, operator_descriptions)
        self.accepted = None

    @property
    def ruleset_enabled(self) -> bool:
        """Ruleset editing is only live in automatic-assignment mode
        (MessageTypeDialog.py:74-80)."""
        return self.message_type.assigned_by_ruleset

    def add_rule(self):
        self.message_type.ruleset.append(
            Rule(start=0, end=0, operator="=", target_value="1", value_type=0))

    def remove_rule(self):
        if len(self.message_type.ruleset):
            self.message_type.ruleset.remove(self.message_type.ruleset[-1])

    def set_assigned_automatically(self, value: bool):
        self.message_type.assigned_by_ruleset = bool(value)

    def set_ruleset_mode(self, index: int):
        self.message_type.ruleset.mode = Mode(index)

    def accept(self):
        self.accepted = True

    def reject(self):
        self.message_type.ruleset = self.original_ruleset
        self.message_type.assigned_by_ruleset = self.original_assigned_status
        self.accepted = False


class SignalDetailsDialogController:
    """Signal metadata view (dialogs/SignalDetailsDialog.py:14-64): file
    facts plus an editable sample rate that recomputes the duration."""

    def __init__(self, signal):
        self.signal = signal
        file = signal.filename or ""
        if file and os.path.isfile(file):
            self.file = file
            self.file_size = "{:.2f}MB".format(os.path.getsize(file) / (1024 ** 2))
            self.file_created = time.ctime(os.path.getctime(file))
        else:
            self.file = "signal file not found"
            self.file_size = "-"
            self.file_created = "-"

    @property
    def name(self):
        return self.signal.name

    @property
    def num_samples(self) -> int:
        return self.signal.num_samples

    @property
    def sample_rate(self) -> float:
        return self.signal.sample_rate

    @sample_rate.setter
    def sample_rate(self, value: float):
        self.signal.sample_rate = value

    @property
    def duration(self) -> str:
        return Formatter.science_time(self.signal.num_samples
                                      / self.signal.sample_rate)


class FuzzingDialogController:
    """Configure fuzz values for one label of one message
    (dialogs/FuzzingDialog.py:14-433): current-label bookkeeping with
    empty-value restoration (:70-85), bit/hex/ascii preview split into
    pre / fuzzed / post segments (:154-185), label range edits that clear
    stale fuzz values (:193-213), and range/boundary/random value
    generation via the fuzzing table model (:344-374)."""

    def __init__(self, protocol, label_index: int = 0, msg_index: int = 0,
                 proto_view: int = VIEW_BIT):
        self.protocol = protocol
        self.msg_index = msg_index
        self.current_label_index = label_index
        self.proto_view = proto_view
        self.fuzz_table_model = FuzzingTableModel(self.current_label, proto_view)
        # the dialog's remove-duplicates checkbox starts unchecked
        # (FuzzingDialog.py:254-260 only dedups once toggled on)
        self.fuzz_table_model.remove_duplicates = False

    @property
    def message(self):
        return self.protocol.messages[self.msg_index]

    @property
    def current_label(self) -> ProtocolLabel:
        """FuzzingDialog.py:70-85: work on a copy stored back into the
        message type; drop empty fuzz values; seed with the label's current
        plain bits when no fuzz value remains."""
        if len(self.message.message_type) == 0:
            return None
        cur_label = self.message.message_type[self.current_label_index].get_copy()
        self.message.message_type[self.current_label_index] = cur_label
        cur_label.fuzz_values = [fv for fv in cur_label.fuzz_values if fv]
        if len(cur_label.fuzz_values) == 0:
            cur_label.fuzz_values.append(
                self.message.plain_bits_str[cur_label.start:cur_label.end])
        return cur_label

    @property
    def current_label_start(self) -> int:
        if self.current_label and self.message:
            return self.message.get_label_range(
                self.current_label, self.proto_view, False)[0]
        return -1

    @property
    def current_label_end(self) -> int:
        if self.current_label and self.message:
            return self.message.get_label_range(
                self.current_label, self.proto_view, False)[1]
        return -1

    @property
    def message_data(self) -> str:
        if self.proto_view == VIEW_BIT:
            return self.message.plain_bits_str
        if self.proto_view == VIEW_HEX:
            return self.message.plain_hex_str
        if self.proto_view == VIEW_ASCII:
            return self.message.plain_ascii_str
        return None

    def message_data_preview(self):
        """(pre, fuzzed, post) strings as shown by the dialog's three labels
        (FuzzingDialog.py:154-185)."""
        fuz_start = self.current_label_start
        fuz_end = self.current_label_end
        num_proto_bits, num_fuz_bits = 10, 16

        proto_start = fuz_start - num_proto_bits
        preambel = "... "
        if proto_start <= 0:
            proto_start, preambel = 0, ""

        proto_end = fuz_end + num_proto_bits
        postambel = " ..."
        if proto_end >= len(self.message_data) - 1:
            proto_end, postambel = len(self.message_data) - 1, ""

        fuzamble = ""
        if fuz_end - fuz_start > num_fuz_bits:
            fuz_end = fuz_start + num_fuz_bits
            fuzamble = "..."

        return (preambel + self.message_data[proto_start:self.current_label_start],
                self.message_data[fuz_start:fuz_end] + fuzamble,
                self.message_data[self.current_label_end:proto_end] + postambel)

    def set_current_label_index(self, index: int):
        self.current_label_index = index
        self.fuzz_table_model.fuzzing_label = self.current_label
        self.fuzz_table_model.update()

    def set_fuzzing_start(self, value: int):
        """1-based start in the current view; clears stale fuzz values
        (FuzzingDialog.py:193-201)."""
        new_start = self.message.convert_index(
            value - 1, self.proto_view, 0, False)[0]
        lbl = self.current_label
        lbl.start = int(new_start)
        lbl.fuzz_values[:] = []
        self.fuzz_table_model.fuzzing_label = self.current_label
        self.fuzz_table_model.update()

    def set_fuzzing_end(self, value: int):
        new_end = self.message.convert_index(
            value - 1, self.proto_view, 0, False)[1] + 1
        lbl = self.current_label
        lbl.end = int(new_end)
        lbl.fuzz_values[:] = []
        self.fuzz_table_model.fuzzing_label = self.current_label
        self.fuzz_table_model.update()

    def add_row(self):
        self.current_label.add_fuzz_value()
        self.fuzz_table_model.fuzzing_label = self.current_label
        self.fuzz_table_model.update()

    def delete_lines(self, min_row: int = -1, max_row: int = -1):
        """FuzzingDialog.py:240-252; deleting everything restores one value
        via the current_label property."""
        lbl = self.current_label
        if min_row == -1:
            lbl.fuzz_values = lbl.fuzz_values[:-1]
        else:
            lbl.fuzz_values = (lbl.fuzz_values[:min_row]
                               + lbl.fuzz_values[max_row + 1:])
        lbl = self.current_label
        self.fuzz_table_model.fuzzing_label = lbl
        self.fuzz_table_model.update()

    def add_range(self, start: int, end: int, step: int = 1):
        self.fuzz_table_model.fuzzing_label = self.current_label
        self.fuzz_table_model.add_range(start, end, step)

    def add_boundaries(self, lower: int, upper: int, num_vals: int = 1):
        self.fuzz_table_model.fuzzing_label = self.current_label
        self.fuzz_table_model.add_boundaries(lower, upper, num_vals)

    def add_random(self, number: int, minimum: int, maximum: int, seed=None):
        self.fuzz_table_model.fuzzing_label = self.current_label
        self.fuzz_table_model.add_random(number, minimum, maximum, seed)

    def repeat_values(self, start: int, end: int, times: int):
        self.fuzz_table_model.fuzzing_label = self.current_label
        self.fuzz_table_model.repeat_fuzzing_values(start, end, times)

    def set_remove_duplicates(self, value: bool):
        """FuzzingDialog.py:254-260."""
        self.fuzz_table_model.remove_duplicates = bool(value)
        self.fuzz_table_model.fuzzing_label = self.current_label
        self.fuzz_table_model.update()


class ModulationParametersDialogController:
    """Per-symbol parameter table for 2^bits symbols
    (dialogs/ModulationParametersDialog.py:11-69): bit-pattern row headers,
    unit by modulation type, values written back on accept."""

    def __init__(self, parameters: list, modulation_type: str):
        self.parameters = parameters
        self.num_bits = int(math.log2(len(parameters)))
        if "FSK" in modulation_type:
            self.unit = "Frequency in Hz"
        elif "ASK" in modulation_type:
            self.unit = "Amplitude"
        elif "PSK" in modulation_type:
            self.unit = "Phase"
        else:
            self.unit = ""
        self.edited = list(parameters)

    def bit_pattern(self, row: int) -> str:
        return "{0:0{1}b}".format(row, self.num_bits)

    def set_value(self, row: int, value: float):
        self.edited[row] = float(value)

    def accept(self):
        for i, value in enumerate(self.edited):
            self.parameters[i] = float(value)


class AdvancedModulationOptionsController:
    """Pause threshold + message length divisor editing
    (dialogs/AdvancedModulationOptionsDialog.py:7-40): emits change events
    only for values that differ on accept."""

    def __init__(self, pause_threshold: int, message_length_divisor: int):
        self.pause_threshold = pause_threshold
        self.message_length_divisor = message_length_divisor
        self._new_pause_threshold = pause_threshold
        self._new_message_length_divisor = message_length_divisor
        self.pause_threshold_edited = Event(int)
        self.message_length_divisor_edited = Event(int)

    def set_pause_threshold(self, value: int):
        self._new_pause_threshold = int(value)

    def set_message_length_divisor(self, value: int):
        self._new_message_length_divisor = int(value)

    def accept(self):
        if self.pause_threshold != self._new_pause_threshold:
            self.pause_threshold_edited.emit(self._new_pause_threshold)
        if self.message_length_divisor != self._new_message_length_divisor:
            self.message_length_divisor_edited.emit(
                self._new_message_length_divisor)
