"""Headless table/list/tree models for protocol data (PyTorch port of
urh_tpu.ui.models; host logic, no tensors).

Re-design of the reference's Qt model layer (models/TableModel.py,
ProtocolTableModel.py, GeneratorTableModel.py, LabelValueTableModel.py,
PLabelTableModel.py, FuzzingTableModel.py, ParticipantListModel.py,
MessageTypeTableModel.py, RulesetTableModel.py, ProtocolTreeModel.py) as
plain-Python view models: the same display/diff/search/edit logic, minus
QAbstractTableModel plumbing, so they are equally usable from a GUI
binding, a notebook, or tests.
"""

from __future__ import annotations

import array
import math
from collections import defaultdict

from urh_tpu_torch.protocol.labels import ChecksumLabel, ProtocolLabel
from urh_tpu_torch.ui.undo import UndoStack
from urh_tpu_torch.util import misc as util
from urh_tpu_torch.util.events import Event

VIEW_BIT, VIEW_HEX, VIEW_ASCII = 0, 1, 2


class TableModel:
    """Core display logic shared by the analysis (decoded) and generator
    (plain, writeable) protocol tables (models/TableModel.py:16-470)."""

    ALIGNMENT_CHAR = " "

    def __init__(self, participants=None):
        self.controller = None
        self.protocol = None
        self.col_count = 0
        self.row_count = 0
        self.display_data = None  # list[array-like of int codes / bits]

        self.search_results = []
        self.search_value = ""
        self._proto_view = VIEW_BIT
        self._refindex = -1

        self.hidden_rows = set()
        self.is_writeable = False
        self.decode = True  # False for the generator model
        self._diffs = defaultdict(set)

        self.vertical_header_text = defaultdict(lambda: None)
        self.vertical_header_colors = defaultdict(lambda: None)

        self.undo_stack = UndoStack()
        self.data_edited = Event(int, int)
        self.__participants = participants if participants is not None else []

    # -- config ------------------------------------------------------------
    @property
    def participants(self):
        return self.__participants

    @participants.setter
    def participants(self, value):
        self.__participants = value
        if self.protocol is not None:
            for msg in self.protocol.messages:
                if msg.participant not in self.__participants:
                    msg.participant = None

    @property
    def proto_view(self):
        return self._proto_view

    @proto_view.setter
    def proto_view(self, value):
        self._proto_view = value
        if self._refindex >= 0:
            self._diffs = self.find_differences(self._refindex)
        self.update()

    @property
    def refindex(self):
        return self._refindex

    @refindex.setter
    def refindex(self, refindex):
        if refindex != self._refindex:
            self._refindex = refindex
            self.update()

    @property
    def diffs(self) -> dict:
        return self._diffs

    def get_alignment_offset_at(self, index: int) -> int:
        f = 1 if self.proto_view == VIEW_BIT else 4 if self.proto_view == VIEW_HEX else 8
        return int(math.ceil(self.protocol.messages[index].alignment_offset / f))

    # -- refresh -------------------------------------------------------------
    def update(self):
        if self.protocol is not None and self.protocol.num_messages > 0:
            messages = self.protocol.messages
            if self.decode:
                views = {VIEW_BIT: lambda m: m.decoded_bits,
                         VIEW_HEX: lambda m: m.decoded_hex_array,
                         VIEW_ASCII: lambda m: m.decoded_ascii_array}
            else:
                views = {VIEW_BIT: lambda m: m.plain_bits,
                         VIEW_HEX: lambda m: m.plain_hex_array,
                         VIEW_ASCII: lambda m: m.plain_ascii_array}
            self.display_data = [views[self.proto_view](msg) for msg in messages]

            visible = [i for i in range(len(self.display_data))
                       if i not in self.hidden_rows]
            self.col_count = max(
                (len(self.display_data[i]) + self.get_alignment_offset_at(i)
                 for i in visible), default=0)
            if self._refindex >= 0:
                self._diffs = self.find_differences(self._refindex)
            else:
                self._diffs.clear()
            self.row_count = self.protocol.num_messages
            self.find_protocol_value(self.search_value)
        else:
            self.col_count = 0
            self.row_count = 0
            self.display_data = None
        self.refresh_vertical_header()

    def refresh_vertical_header(self):
        self.vertical_header_colors.clear()
        self.vertical_header_text.clear()
        if self.protocol is None:
            return
        for i, msg in enumerate(self.protocol.messages):
            participant = msg.participant
            if participant is not None:
                self.vertical_header_text[i] = f"{i + 1} ({participant.shortname})"
                self.vertical_header_colors[i] = participant.color_index
            else:
                self.vertical_header_text[i] = str(i + 1)

    # -- cell access -----------------------------------------------------------
    def data(self, row: int, col: int):
        """Display string for one cell; None past end of message."""
        if self.display_data is None or row >= len(self.display_data):
            return None
        alignment_offset = self.get_alignment_offset_at(row)
        if col < alignment_offset:
            return self.ALIGNMENT_CHAR
        try:
            item = self.display_data[row][col - alignment_offset]
        except IndexError:
            return None
        if self.proto_view == VIEW_BIT:
            return str(int(item))
        if self.proto_view == VIEW_HEX:
            return f"{int(item):x}"
        return chr(int(item))

    def row_text(self, row: int) -> str:
        return "".join(self.data(row, c) or "" for c in range(self.col_count))

    # -- diffs ----------------------------------------------------------------
    def find_differences(self, refindex: int) -> dict:
        """Columns differing from the reference row, per row
        (TableModel.py:415-470)."""
        differences = defaultdict(set)
        if self.protocol is None or refindex >= self.protocol.num_messages:
            return differences
        if self.decode:
            proto = self.protocol.decoded_to_str_list(self.proto_view)
        else:
            proto = [self.protocol.messages[i].view_to_string(
                self.proto_view, decoded=False, show_pauses=False)
                for i in range(self.protocol.num_messages)]
        ref_message = proto[refindex]
        ref_offset = self.get_alignment_offset_at(refindex)
        for i, message in enumerate(proto):
            if i == refindex:
                continue
            msg_offset = self.get_alignment_offset_at(i)
            short, long_ = sorted([len(ref_message) + ref_offset,
                                   len(message) + msg_offset])
            differences[i] = {
                j for j in range(short)
                if (j < msg_offset or j < ref_offset
                    or message[j - msg_offset] != ref_message[j - ref_offset])
            } | set(range(short, long_))
        return differences

    # -- search ----------------------------------------------------------------
    def find_protocol_value(self, value) -> int:
        """Populate search_results with (row, start_col, end_col) triples."""
        self.search_results.clear()
        if self.proto_view == VIEW_HEX:
            value = value.lower()
        self.search_value = value
        if len(value) == 0 or self.protocol is None:
            return 0
        for i, message in enumerate(self.protocol.messages):
            if i in self.hidden_rows:
                continue
            if self.decode:
                data = message.view_to_string(self.proto_view, decoded=True,
                                              show_pauses=False)
            else:
                data = message.view_to_string(self.proto_view, decoded=False,
                                              show_pauses=False)
            j = data.find(value)
            while j != -1:
                self.search_results.append((i, j, j + len(value)))
                j = data.find(value, j + 1)
        return len(self.search_results)

    # -- editing (generator) ------------------------------------------------------
    def _pad_until_index(self, row: int, bit_pos: int) -> bool:
        """Zero-pad message so the user can type past its end
        (TableModel.py:86-108)."""
        try:
            new_bits = array.array(
                "B", [0] * max(0, bit_pos - len(self.protocol.messages[row])))
            if len(new_bits) > 0:
                self.protocol.messages[row].plain_bits = (
                    self.protocol.messages[row].plain_bits + new_bits)
        except IndexError:
            return False
        return True

    def set_data(self, row: int, col: int, value: str) -> bool:
        """Type a bit / hex nibble / ascii char into a writeable table."""
        if not self.is_writeable:
            return False
        nbits = 1 if self.proto_view == VIEW_BIT else 4 if self.proto_view == VIEW_HEX else 8
        bit_pos = col * nbits
        if not self._pad_until_index(row, bit_pos + nbits):
            return False
        msg = self.protocol.messages[row]
        if self.proto_view == VIEW_BIT:
            if value not in ("0", "1"):
                return False
            bits = [int(value)]
        else:
            try:
                number = int(value, 16) if self.proto_view == VIEW_HEX else ord(value)
            except (ValueError, TypeError):
                return False
            bits = [int(b) for b in f"{number:0{nbits}b}"]
        for k, bit in enumerate(bits):
            msg[bit_pos + k] = bool(bit)
        self.update()
        self.data_edited.emit(row, col)
        return True


class ProtocolTableModel(TableModel):
    """Analysis-tab table: decoded view of all visible protocols
    (models/ProtocolTableModel.py:15-85)."""

    def __init__(self, proto_analyzer, participants=None, controller=None):
        super().__init__(participants)
        self.protocol = proto_analyzer
        self.controller = controller
        self.is_writeable = False
        self.decode = True

    def delete_range(self, msg_start: int, msg_end: int, index_start: int,
                     index_end: int):
        """Push an undoable DeleteBitsAndPauses."""
        from urh_tpu_torch.ui.actions import DeleteBitsAndPauses
        if msg_start > msg_end:
            msg_start, msg_end = msg_end, msg_start
        if index_start > index_end:
            index_start, index_end = index_end, index_start
        cmd = DeleteBitsAndPauses(self.protocol, msg_start, msg_end, index_start,
                                  index_end, self.proto_view, self.decode)
        self.undo_stack.push(cmd)
        self.update()

    def get_selected_label_index(self, row: int, column: int) -> int:
        """Index of the label covering a cell, -1 if none
        (ProtocolTableModel behavior used by the analysis context menu)."""
        if self.protocol is None or row >= self.protocol.num_messages:
            return -1
        msg = self.protocol.messages[row]
        for i, lbl in enumerate(msg.message_type):
            start, end = msg.get_label_range(lbl, self.proto_view, self.decode)
            if start <= column < end:
                return i
        return -1


class GeneratorTableModel(TableModel):
    """Generator-tab table: plain (encoded) view, writeable, with fuzzing
    label highlighting and drag-drop insertion of analyzer protocols
    (models/GeneratorTableModel.py:21-271)."""

    def __init__(self, tree_root_item=None, decodings=None, participants=None):
        super().__init__(participants)
        from urh_tpu_torch.protocol.container import ProtocolAnalyzerContainer
        self.protocol = ProtocolAnalyzerContainer()
        self.tree_root_item = tree_root_item
        self.decodings = decodings if decodings is not None else []
        self.is_writeable = True
        self.decode = False
        self.dropped_row = 0

    def refresh_fonts(self):
        """Per-cell fuzz highlight map: {(row, col): label} for active
        fuzzing labels (GeneratorTableModel.py bold/orange cells)."""
        highlights = {}
        for i, message in enumerate(self.protocol.messages):
            for lbl in message.active_fuzzing_labels:
                start, end = message.get_label_range(lbl, self.proto_view, False)
                for j in range(start, end):
                    highlights[(i, j)] = lbl
        return highlights

    def insert_protocol(self, protocol, index: int = -1):
        from urh_tpu_torch.ui.actions import InsertBitsAndPauses
        self.undo_stack.push(InsertBitsAndPauses(self.protocol, index, protocol))
        self.update()

    def duplicate_rows(self, rows: list):
        self.protocol.duplicate_lines(rows)
        self.update()

    def add_empty_row_behind(self, row_index: int, num_bits: int):
        from urh_tpu_torch.protocol.message import Message
        message = Message(plain_bits=[0] * num_bits, pause=settings_default_pause(),
                          message_type=self.protocol.default_message_type)
        self.protocol.messages.insert(row_index + 1, message)
        self.update()

    def fuzz(self, mode: str):
        from urh_tpu_torch.ui.actions import Fuzz
        self.undo_stack.push(Fuzz(self.protocol, mode))
        self.update()

    def clear(self):
        from urh_tpu_torch.ui.actions import Clear
        self.undo_stack.push(Clear(self.protocol))
        self.update()


def settings_default_pause() -> int:
    from urh_tpu_torch.util import settings
    return settings.read("default_fuzzing_pause", 10**6, int)


class LabelValueTableModel:
    """Per-message label value list for the analysis tab
    (models/LabelValueTableModel.py:15-210): name, color, display format,
    bit order, and rendered value (with checksum verification)."""

    header_labels = ["Name", "Color ", "Display format", "Order [Bit/Byte]", "Value"]

    def __init__(self, proto_analyzer, controller=None):
        self.proto_analyzer = proto_analyzer
        self.controller = controller
        self._message_index = 0
        self.show_label_values = True

    @property
    def display_labels(self):
        if self.controller is not None:
            return self.controller.active_message_type
        msg = self.message
        return msg.message_type if msg is not None else []

    @property
    def message_index(self):
        return self._message_index

    @message_index.setter
    def message_index(self, value):
        self._message_index = value

    @property
    def message(self):
        if 0 <= self._message_index < len(self.proto_analyzer.messages):
            return self.proto_analyzer.messages[self._message_index]
        return None

    @property
    def row_count(self):
        return len(self.display_labels)

    def _value_string(self, lbl, expected_checksum=None):
        if not self.show_label_values or self.message is None:
            return "-"
        try:
            data = self.message.decoded_bits[lbl.start:lbl.end]
        except IndexError:
            return None
        lsb = lbl.display_bit_order_index == 1
        lsd = lbl.display_bit_order_index == 2
        value = util.convert_bits_to_string(
            data, lbl.display_format_index, pad_zeros=True, lsb=lsb, lsd=lsd,
            endianness=lbl.display_endianness)
        if value is None:
            return None
        if expected_checksum is not None:
            value += " (should be {0})".format(util.convert_bits_to_string(
                expected_checksum, lbl.display_format_index))
        return value

    def row(self, i: int) -> dict:
        lbl = self.display_labels[i]
        calculated_crc = None
        checksum_ok = None
        if isinstance(lbl, ChecksumLabel) and self.message is not None:
            calculated_crc = lbl.calculate_checksum_for_message(
                self.message, use_decoded_bits=True)
            actual = self.message.decoded_bits[lbl.start:lbl.end]
            checksum_ok = bool(array.array("B", calculated_crc) ==
                               array.array("B", actual))
        expected = calculated_crc if checksum_ok is False else None
        return {
            "name": lbl.name,
            "color_index": lbl.color_index,
            "display_format": ProtocolLabel.DISPLAY_FORMATS[lbl.display_format_index],
            "order": ProtocolLabel.DISPLAY_BIT_ORDERS[lbl.display_bit_order_index],
            "value": self._value_string(lbl, expected),
            "checksum_ok": checksum_ok,
        }

    def rows(self):
        return [self.row(i) for i in range(self.row_count)]


class PLabelTableModel:
    """Editable label table of one message type (models/PLabelTableModel.py):
    name / start / end / color / apply-decoding.  When constructed with a
    message, start/end display in the current bit/hex/ascii view and edits
    convert back to bit indices (PLabelTableModel.py:77-87,120-127);
    without one, indices are raw bit positions and only view 0 is valid."""

    header_labels = ["Name", "Start", "End", "Color", "Apply decoding"]

    def __init__(self, message_type, field_types=None, message=None):
        self.message_type = message_type
        self.message = message
        self.proto_view = 0
        self.field_types_by_caption = (
            {ft.caption: ft for ft in field_types} if field_types else {})

    @property
    def row_count(self):
        return len(self.message_type)

    def label_at(self, row: int) -> ProtocolLabel:
        return self.message_type[row]

    def _display_range(self, lbl) -> tuple:
        if self.message is None:
            return lbl.start, lbl.end
        return self.message.get_label_range(lbl, view=self.proto_view, decode=True)

    def _to_bit_index(self, view_index: int) -> int:
        if self.message is None:
            return view_index
        return int(self.message.convert_index(
            view_index, from_view=self.proto_view, to_view=0, decoded=True)[0])

    def row(self, i: int) -> dict:
        lbl = self.message_type[i]
        start, end = self._display_range(lbl)
        return {"name": lbl.name, "start": start + 1, "end": end,
                "color_index": lbl.color_index,
                "apply_decoding": lbl.apply_decoding}

    def set_field(self, row: int, field: str, value) -> bool:
        lbl = self.message_type[row]
        if field == "name":
            if not value:
                return False
            lbl.name = value
            if value in self.field_types_by_caption:
                lbl.field_type = self.field_types_by_caption[value]
            else:
                lbl.field_type = None
            return True
        if field == "start":
            lbl.start = self._to_bit_index(int(value) - 1)
            return True
        if field == "end":
            lbl.end = self._to_bit_index(int(value))
            return True
        if field == "color_index":
            lbl.color_index = int(value)
            return True
        if field == "apply_decoding":
            lbl.apply_decoding = bool(value)
            return True
        return False

    def remove_label_at(self, row: int):
        lbl = self.message_type[row]
        self.message_type.remove(lbl)
        return lbl


class FuzzingTableModel:
    """Fuzz-value table of one label (models/FuzzingTableModel.py:11-170):
    values rendered per view, editable, plus range/boundary/random helpers
    matching the FuzzingDialog semantics."""

    def __init__(self, fuzzing_label: ProtocolLabel, proto_view: int = VIEW_BIT):
        self.fuzzing_label = fuzzing_label
        self.proto_view = proto_view
        self.remove_duplicates = True

    @property
    def fuzz_values(self):
        return self.fuzzing_label.fuzz_values if self.fuzzing_label else []

    @property
    def row_count(self):
        return len(self.fuzz_values)

    @property
    def col_count(self):
        if not self.fuzz_values:
            return 0
        n = len(self.fuzz_values[0])
        return n if self.proto_view == VIEW_BIT else math.ceil(
            n / (4 if self.proto_view == VIEW_HEX else 8))

    def update(self):
        if self.remove_duplicates and self.fuzzing_label:
            seen = set()
            self.fuzzing_label.fuzz_values = [
                v for v in self.fuzzing_label.fuzz_values
                if not (v in seen or seen.add(v))]

    def data(self, i: int, j: int):
        value = self.fuzz_values[i]
        if self.proto_view == VIEW_BIT:
            return value[j]
        if self.proto_view == VIEW_HEX:
            return f"{int(value[4 * j:4 * (j + 1)], 2):x}"
        return chr(int(value[8 * j:8 * (j + 1)], 2))

    def set_bit(self, i: int, j: int, value: str):
        if self.proto_view != VIEW_BIT or value not in ("0", "1"):
            return False
        chars = list(self.fuzz_values[i])
        chars[j] = value
        self.fuzzing_label.fuzz_values[i] = "".join(chars)
        self.update()
        return True

    # -- FuzzingDialog helpers ------------------------------------------------
    def _append_decimal(self, value: int):
        """Clamp to the label's value capacity and append as bits.

        Out-of-range requests saturate at fuzz_maximum - 1 (like the
        reference's clamping, FuzzingTableModel.py:122-158) instead of
        aliasing modulo 2^bits."""
        n = len(self.fuzzing_label.fuzz_values[0])
        value = max(0, min(int(value), 2 ** n - 1))
        self.fuzzing_label.fuzz_values.append(f"{value:0{n}b}")

    def add_range(self, start: int, end: int, step: int = 1):
        # NOTE: end-INCLUSIVE by design (the reference's range is
        # end-exclusive, FuzzingTableModel.py:121-127)
        for v in range(start, end + 1, step):
            self._append_decimal(v)
        self.update()

    def add_boundaries(self, lower: int, upper: int, num_vals: int = 1):
        for i in range(num_vals):
            if lower >= 0:
                self._append_decimal(lower + i)
            if upper >= 0:
                self._append_decimal(upper - i)
        self.update()

    def add_random(self, number: int, minimum: int, maximum: int, seed=None):
        import random
        rnd = random.Random(seed)
        n = len(self.fuzzing_label.fuzz_values[0])
        cap = 2 ** n - 1
        minimum, maximum = min(minimum, cap), min(maximum, cap)
        for _ in range(number):
            self._append_decimal(rnd.randint(minimum, maximum))
        self.update()

    def repeat_fuzzing_values(self, start: int, end: int, times: int):
        """Insert `times` copies of each value in [start, end) after it
        (FuzzingTableModel.py:161-167), then re-apply duplicate removal."""
        for i in reversed(range(start, end)):
            value = self.fuzz_values[i]
            for _ in range(times):
                self.fuzzing_label.fuzz_values.insert(i, value)
        self.update()

    def remove_rows(self, rows: list):
        for i in sorted(rows, reverse=True):
            del self.fuzzing_label.fuzz_values[i]


class ParticipantListModel:
    """Show/hide checklist of participants (models/ParticipantListModel.py)."""

    def __init__(self, participants):
        self.participants = participants
        self.show_state_changed = Event()

    @property
    def row_count(self):
        return len(self.participants)

    def text(self, row: int) -> str:
        p = self.participants[row]
        return f"{p.name} ({p.shortname})"

    def set_shown(self, row: int, shown: bool):
        if self.participants[row].show != shown:
            self.participants[row].show = shown
            self.show_state_changed.emit()


class MessageTypeTableModel:
    """Message-type list with visibility checkboxes
    (models/MessageTypeTableModel.py)."""

    def __init__(self, message_types):
        self.message_types = message_types
        self.message_type_visibility_changed = Event(object)
        self.message_type_name_edited = Event(str)

    @property
    def row_count(self):
        return len(self.message_types)

    def row(self, i: int) -> dict:
        mt = self.message_types[i]
        return {"name": mt.name, "show": bool(mt.show),
                "has_assign_rules": len(mt.ruleset) > 0,
                "assigned_by_ruleset": mt.assigned_by_ruleset}

    def set_shown(self, row: int, shown: bool):
        mt = self.message_types[row]
        if bool(mt.show) != shown:
            mt.show = shown
            self.message_type_visibility_changed.emit(mt)

    def set_name(self, row: int, name: str):
        if name:
            self.message_types[row].name = name
            self.message_type_name_edited.emit(name)


class RulesetTableModel:
    """Rule table of one message type's assignment ruleset
    (models/RulesetTableModel.py)."""

    header_labels = ["Start", "End", "View type", "Operator", "Value"]

    def __init__(self, ruleset, operator_descriptions=None):
        self.ruleset = ruleset
        self.operator_descriptions = operator_descriptions or []

    @property
    def row_count(self):
        return len(self.ruleset)

    def row(self, i: int) -> dict:
        rule = self.ruleset[i]
        return {"start": rule.start + 1, "end": rule.end, "view_type": rule.value_type,
                "operator": rule.operator, "value": rule.target_value}


class SimulatorMessageTableModel(TableModel):
    """Message table of the simulator tab
    (models/SimulatorMessageTableModel.py): plain view over the simulator
    configuration's messages."""

    def __init__(self, simulator_config, participants=None):
        super().__init__(participants)
        self.simulator_config = simulator_config
        self.decode = False
        self.is_writeable = False

    def update(self):
        class _Shim:
            pass
        msgs = self.simulator_config.get_all_messages()
        shim = _Shim()
        shim.messages = msgs
        shim.num_messages = len(msgs)
        self.protocol = shim
        super().update()


class SimulatorMessageFieldModel:
    """Label/value table of one simulator message
    (models/SimulatorMessageFieldModel.py): per-label value-type and value
    with live formula validation."""

    header_labels = ["Name", "Display format", "Value type", "Value"]

    def __init__(self, controller=None):
        self.controller = controller
        self.message = None

    @property
    def row_count(self):
        return len(self.message.message_type) if self.message is not None else 0

    def row(self, i: int) -> dict:
        from urh_tpu_torch.sim.items import SimulatorProtocolLabel
        lbl = self.message.message_type[i]  # type: SimulatorProtocolLabel
        value = None
        if lbl.value_type_index == 0:  # constant
            start, end = self.message.get_label_range(lbl, VIEW_BIT, False)
            value = "".join(str(int(b)) for b in self.message.plain_bits[start:end])
        elif lbl.value_type_index == 2:
            value = lbl.formula
        elif lbl.value_type_index == 3:
            value = lbl.external_program
        elif lbl.value_type_index == 4:
            value = f"Range (Decimal): {lbl.random_min} - {lbl.random_max}"
        return {"name": lbl.name,
                "display_format": ProtocolLabel.DISPLAY_FORMATS[lbl.display_format_index],
                "value_type": lbl.VALUE_TYPES[lbl.value_type_index],
                "value": value}


class ProtocolTreeItem:
    """Node of the protocol tree (models/ProtocolTreeItem.py): either a
    group (children = protocol items) or a leaf wrapping a protocol."""

    def __init__(self, data=None, parent=None):
        self._data = data  # ProtocolAnalyzer or None for groups/root
        self.parent = parent
        self.children = []
        self.copy_data = False
        self._copy = None

    @property
    def protocol(self):
        if self.copy_data:
            if self._copy is None:
                import copy as _copy
                self._copy = _copy.deepcopy(self._data)
            return self._copy
        return self._data

    def clear_copy(self):
        self._copy = None

    @property
    def is_group(self):
        return self._data is None

    @property
    def name(self):
        if self.is_group:
            return getattr(self, "group_name", "Group")
        return self._data.name

    def add_child(self, child: "ProtocolTreeItem"):
        child.parent = self
        self.children.append(child)

    def remove_child(self, child: "ProtocolTreeItem"):
        self.children.remove(child)

    def index_in_parent(self):
        return self.parent.children.index(self) if self.parent else 0


class ProtocolTreeModel:
    """Grouped protocol tree shared by analysis and generator tabs
    (models/ProtocolTreeModel.py): groups contain protocols; group moves,
    deletion (children re-homed), and per-item show state."""

    def __init__(self):
        self.root_item = ProtocolTreeItem()
        first_group = ProtocolTreeItem()
        first_group.group_name = "New Group"
        self.root_item.add_child(first_group)
        self.group_deleted = Event(int, int)
        self.proto_to_group_added = Event(int)

    @property
    def groups(self):
        return self.root_item.children

    @property
    def ngroups(self):
        return len(self.groups)

    @property
    def protocols(self) -> dict:
        """group index -> list of protocols."""
        return {i: [c.protocol for c in grp.children]
                for i, grp in enumerate(self.groups)}

    @property
    def protocol_list(self):
        return [c.protocol for grp in self.groups for c in grp.children]

    def group_at(self, index: int) -> ProtocolTreeItem:
        return self.groups[index]

    def add_group(self, name: str = "New Group") -> ProtocolTreeItem:
        group = ProtocolTreeItem()
        group.group_name = name
        self.root_item.add_child(group)
        return group

    def add_protocol(self, protocol, group_id: int = 0):
        group_id = min(group_id, self.ngroups - 1)
        item = ProtocolTreeItem(protocol)
        self.groups[group_id].add_child(item)
        self.proto_to_group_added.emit(group_id)
        return item

    def remove_protocol(self, protocol) -> bool:
        for grp in self.groups:
            for child in list(grp.children):
                if child.protocol is protocol:
                    grp.remove_child(child)
                    return True
        return False

    def move_to_group(self, items, new_group_id: int):
        group = self.groups[new_group_id]
        for item in items:
            item.parent.remove_child(item)
            group.add_child(item)

    def delete_group(self, group_id: int):
        if self.ngroups == 1:
            raise ValueError("Cannot delete last group")
        group = self.groups[group_id]
        new_group_id = group_id - 1 if group_id > 0 else 1
        new_group = self.groups[new_group_id]
        for child in list(group.children):
            group.remove_child(child)
            new_group.add_child(child)
        self.root_item.remove_child(group)
        self.group_deleted.emit(group_id, new_group_id if group_id > 0 else 0)


class FileProxyModel:
    """Filename filter used by the file tree (models/FileFilterProxyModel.py):
    accept directories and files with loadable extensions."""

    def __init__(self, extensions=None):
        from urh_tpu_torch.util.file_operator import get_open_filename_filters
        self.extensions = (extensions if extensions is not None
                           else get_open_filename_filters())

    def accept(self, path: str) -> bool:
        import os
        if os.path.isdir(path):
            return True
        return any(path.endswith(ext) for ext in self.extensions)


class PluginListModel:
    """Checkable plugin list (models/PluginListModel.py:8-60): one row per
    plugin with its name, enabled check state and highlight flag; toggling
    the check state flips ``plugin.enabled``."""

    def __init__(self, plugins, highlighted_plugins=None):
        self.plugins = list(plugins)
        self.highlighted_plugins = (highlighted_plugins
                                    if highlighted_plugins is not None else [])

    @property
    def row_count(self) -> int:
        return len(self.plugins)

    def data(self, row: int, role: str = "display"):
        plugin = self.plugins[row]
        if role == "display":
            return plugin.name
        if role == "check":
            return plugin.enabled
        if role == "highlight":
            return plugin in self.highlighted_plugins
        if role == "description":
            return plugin.description
        return None

    def set_checked(self, row: int, checked: bool):
        self.plugins[row].enabled = bool(checked)
