"""Simulator flow-graph items.

Behavioral contract: urh/simulator/Simulator{Item,Message,ProtocolLabel,
Rule,GotoAction,CounterAction,SleepAction,TriggerCommandAction}.py and
Transcript.py.  Restructured: the action items carry a declarative XML
schema (attribute, parser, default) consumed by shared (de)serializers;
parent constraints are single ``_accepts_parent`` predicates instead of
per-class override chains; the transcript is a flat round-tagged log.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from enum import Enum

from urh_tpu_torch.protocol.labels import (ChecksumLabel, FieldType, MessageType,
                                     Participant, ProtocolLabel)
from urh_tpu_torch.protocol.message import Message
from urh_tpu_torch.util import misc as util


def _parse_bool_int(text: str) -> bool:
    return bool(int(text))


class SimulatorItem:
    simulator_config = None
    expression_parser = None

    # declarative XML: (attribute name, parser, default); None = no attrs
    _XML_TAG = None
    _XML_SCHEMA = ()

    def __init__(self):
        self._parent_item = None
        self._child_items = []
        self.logging_active = True
        self.is_valid = True

    # -- validity ------------------------------------------------------------

    def validate(self):
        return True

    # -- tree ----------------------------------------------------------------

    @staticmethod
    def _accepts_parent(value) -> bool:
        """Override: may `value` become this item's parent?  Most items
        live at top level or under a rule condition."""
        return value.parent() is None or isinstance(value, SimulatorRuleCondition)

    def parent(self):
        return self._parent_item

    def set_parent(self, value):
        if value is not None:
            assert self._accepts_parent(value)
        if self._parent_item is not None:
            self._parent_item.children.remove(self)
        self._parent_item = value

    @property
    def children(self):
        return self._child_items

    def child_count(self) -> int:
        return len(self.children)

    def insert_child(self, pos, child):
        child.set_parent(self)
        self.children.insert(pos, child)

    def add_child(self, child):
        child.set_parent(self)
        self.children.append(child)

    def delete(self):
        for child in self.children[:]:
            child.set_parent(None)
        self.set_parent(None)

    def get_pos(self):
        up = self.parent()
        return up.children.index(self) if up is not None else 0

    def index(self) -> str:
        """Dotted 1-based position, e.g. "2.1" = first child of the
        second top-level item; empty for the root."""
        path = []
        node = self
        while node.parent() is not None:
            path.append(str(node.get_pos() + 1))
            node = node.parent()
        return ".".join(reversed(path))

    def _sibling(self, offset: int):
        up = self.parent()
        if up is None:
            return None
        spot = self.get_pos() + offset
        if 0 <= spot < up.child_count():
            return up.children[spot]
        return None

    def next_sibling(self):
        return self._sibling(+1)

    def prev_sibling(self):
        return self._sibling(-1)

    def next(self):
        """Document-order successor: first child, else the next sibling
        of the nearest ancestor that has one."""
        if self.child_count():
            return self.children[0]
        node = self
        while node is not None:
            after = node.next_sibling()
            if after is not None:
                return after
            node = node.parent()
        return None

    def prev(self):
        """Document-order predecessor: deepest descendant of the
        previous sibling, else the parent."""
        before = self.prev_sibling()
        if before is None:
            return self.parent()
        while before.child_count():
            before = before.children[-1]
        return before

    # -- declarative XML -----------------------------------------------------

    def _schema_attrib(self) -> dict:
        attrib = {}
        for attr, _parse, _default in self._XML_SCHEMA:
            value = getattr(self, attr)
            if value is None:
                continue
            attrib[attr] = str(int(value)) if isinstance(value, bool) else str(value)
        return attrib

    def _apply_schema(self, tag: ET.Element):
        for attr, parse, default in self._XML_SCHEMA:
            raw = tag.get(attr, None)
            if raw is None:
                continue
            try:
                setattr(self, attr, parse(raw))
            except (ValueError, TypeError):
                if default is not None:  # None = keep the constructor value
                    setattr(self, attr, default)
        return self

    def to_xml(self) -> ET.Element:
        return ET.Element(self._XML_TAG, attrib=self._schema_attrib())

    @classmethod
    def from_xml(cls, tag: ET.Element):
        return cls()._apply_schema(tag)


class ConditionType(Enum):
    IF = "IF"
    ELSE_IF = "ELSE IF"
    ELSE = "ELSE"


class SimulatorRule(SimulatorItem):
    _XML_TAG = "simulator_rule"

    @staticmethod
    def _accepts_parent(value) -> bool:
        return value.parent() is None  # rules are top-level only

    @property
    def has_else_condition(self) -> bool:
        return any(child.type is ConditionType.ELSE for child in self.children)

    def get_first_applying_condition(self):
        return next((child for child in self.children if child.condition_applies),
                    None)

    def next_item(self):
        return next((c.children[0] for c in self.children
                     if c.condition_applies and c.child_count()),
                    self.next_sibling())


class SimulatorRuleCondition(SimulatorItem):
    _XML_TAG = "simulator_rule_condition"

    def __init__(self, type: ConditionType = ConditionType.IF):
        super().__init__()
        self.type = type
        self.condition = ""

    @staticmethod
    def _accepts_parent(value) -> bool:
        return isinstance(value, SimulatorRule)

    @property
    def condition_applies(self) -> bool:
        if self.type is ConditionType.ELSE:
            return True
        return self.expression_parser.evaluate_condition(self.condition)

    def validate(self):
        if self.type is ConditionType.ELSE:
            return True
        ok, _, _ = self.expression_parser.validate_expression(self.condition,
                                                              is_formula=False)
        return ok

    def to_xml(self):
        return ET.Element(self._XML_TAG, attrib={"type": self.type.value,
                                                 "condition": self.condition})

    @classmethod
    def from_xml(cls, tag: ET.Element):
        item = cls(type=ConditionType(tag.get("type", ConditionType.IF.value)))
        item.condition = tag.get("condition", "")
        return item


class SimulatorMessage(Message, SimulatorItem):
    _XML_TAG = "simulator_message"

    def __init__(self, destination: Participant, plain_bits, pause: int,
                 message_type: MessageType, decoder=None, source=None,
                 timestamp=None):
        Message.__init__(self, plain_bits, pause, message_type, decoder=decoder,
                         participant=source)
        SimulatorItem.__init__(self)
        if timestamp is not None:
            self.timestamp = timestamp

        self.destination = destination
        self.send_recv_messages = []
        self.repeat = 1

    @property
    def source(self):
        return self.participant

    @source.setter
    def source(self, participant):
        self.participant = participant

    @property
    def children(self):
        return self.message_type

    def insert_child(self, pos, child):
        # labels are unordered within the message type: always append
        self.children.append(child)
        child.set_parent(self)

    def validate(self):
        return all(child.is_valid for child in self.children)

    def _latest(self):
        """Last exchanged (sent or received) message, or the template."""
        return self.send_recv_messages[-1] if self.send_recv_messages else self

    @property
    def plain_ascii_str(self) -> str:
        return "".join(map(chr, self._latest().plain_ascii_array))

    @property
    def plain_bits_str(self) -> str:
        return str(self._latest())

    def __delitem__(self, index):
        dropped = self._remove_labels_for_range(index, instant_remove=False)
        self.simulator_config.delete_items(dropped)
        del self.plain_bits[index]

    def to_xml(self, decoders=None, include_message_type=False,
               write_bits=True) -> ET.Element:
        result = ET.Element(self._XML_TAG, attrib={
            "destination_id": self.destination.id if self.destination else "",
            "repeat": str(self.repeat)})
        result.append(Message.to_xml(self, decoders, include_message_type,
                                     write_bits=write_bits))
        return result

    def from_xml(self, tag: ET.Element, participants, decoders=None,
                 message_types=None):
        Message.from_xml(self, tag, participants, decoders, message_types)
        self.destination = Participant.find_matching(
            tag.get("destination_id", ""), participants)
        try:
            self.repeat = int(tag.get("repeat", "1"))
        except ValueError:
            self.repeat = 1

    @classmethod
    def new_from_xml(cls, tag: ET.Element, participants, decoders=None,
                     message_types=None):
        msg = Message.new_from_xml(tag.find("message"), participants=participants,
                                   decoders=decoders, message_types=message_types)
        destination = Participant.find_matching(tag.get("destination_id", ""),
                                                participants)
        return cls(destination, msg.plain_bits, msg.pause, msg.message_type,
                   msg.decoder, msg.participant, timestamp=msg.timestamp)


class SimulatorProtocolLabel(SimulatorItem):
    VALUE_TYPES = ["Constant value", "Live input", "Formula",
                   "External program", "Random value"]
    _XML_TAG = "simulator_label"

    def __init__(self, label: ProtocolLabel):
        super().__init__()
        self.label = label
        self.value_type_index = 0
        self.external_program = ""
        self.formula = ""
        self.random_min = 0
        self.random_max = self.label.fuzz_maximum - 1

    @staticmethod
    def _accepts_parent(value) -> bool:
        return isinstance(value, SimulatorMessage)

    @property
    def has_live_input(self):
        return not self.is_checksum_label and self.value_type_index == 1

    def get_copy(self):
        return self  # simulator labels are shared, never copied

    def __lt__(self, other):
        return self.label < other.label

    # attribute delegation: unknown reads/writes go to the wrapped label,
    # so a SimulatorProtocolLabel is usable wherever a ProtocolLabel is
    def __getattr__(self, name):
        if name in ("label",):
            return self.__getattribute__("label")
        return getattr(self.__getattribute__("label"), name)

    def __setattr__(self, key, value):
        if key == "field_type":
            super().__setattr__(key, value)
        try:
            object.__getattribute__(self, "label").__setattr__(key, value)
        except AttributeError:
            super().__setattr__(key, value)

    @property
    def field_type(self) -> FieldType:
        return self.label.field_type

    @field_type.setter
    def field_type(self, val: FieldType):
        if val is None:
            return
        if self.is_checksum_label and val.function != FieldType.Function.CHECKSUM:
            assert isinstance(self.label, ChecksumLabel)
            self.label = self.label.to_label(val)
        elif not self.is_checksum_label and val.function == FieldType.Function.CHECKSUM:
            self.label = ChecksumLabel.from_label(self.label)
            self.value_type_index = 0
        self.label.field_type = val

    @property
    def is_checksum_label(self):
        return isinstance(self.label, ChecksumLabel)

    def validate(self):
        if self.value_type_index == 2:
            ok, _, _ = self.expression_parser.validate_expression(self.formula)
            return ok
        if self.value_type_index == 3:
            return util.validate_command(self.external_program)
        return True

    _XML_SCHEMA = (("value_type_index", int, 0),
                   ("external_program", str, ""),
                   ("formula", str, ""),
                   ("random_min", int, 0),
                   ("random_max", int, None))

    def to_xml(self) -> ET.Element:
        result = ET.Element(self._XML_TAG, attrib=self._schema_attrib())
        result.append(self.label.to_xml())
        return result

    @classmethod
    def from_xml(cls, tag: ET.Element, field_types_by_caption=None):
        label_tag = tag.find("label")
        if label_tag is not None:
            label = ProtocolLabel.from_xml(label_tag, field_types_by_caption)
        else:
            label = ChecksumLabel.from_xml(tag.find("checksum_label"),
                                           field_types_by_caption)
        return cls(label)._apply_schema(tag)


class SimulatorGotoAction(SimulatorItem):
    _XML_TAG = "simulator_goto_action"
    _XML_SCHEMA = (("goto_target", str, None),)

    def __init__(self):
        super().__init__()
        self.goto_target = None

    @property
    def target(self):
        return self.simulator_config.item_dict[self.goto_target] \
            if self.validate() else None

    def validate(self):
        target = self.simulator_config.item_dict.get(self.goto_target, None)
        return self.is_valid_goto_target(self.goto_target, target)

    def get_valid_goto_targets(self):
        return [key for key, value in self.simulator_config.item_dict.items()
                if value != self
                and SimulatorGotoAction.is_valid_goto_target(key, value)]

    @staticmethod
    def is_valid_goto_target(caption: str, item: SimulatorItem):
        """Jump targets must be executable flow positions: not labels,
        not rules or their non-IF conditions, not counters, and not a
        trigger command's return-code alias."""
        if item is None:
            return False
        if isinstance(item, (SimulatorProtocolLabel, SimulatorRule,
                             SimulatorCounterAction)):
            return False
        if isinstance(item, SimulatorRuleCondition) and item.type != ConditionType.IF:
            return False
        if isinstance(item, SimulatorTriggerCommandAction) and caption.endswith("rc"):
            return False
        return True


class SimulatorCounterAction(SimulatorItem):
    _XML_TAG = "simulator_counter_action"
    _XML_SCHEMA = (("start", int, 1), ("step", int, 1))

    def __init__(self):
        super().__init__()
        self.start = 1
        self.step = 1
        self._value = self.start

    @property
    def value(self):
        return self._value

    def reset_value(self):
        self._value = self.start

    def progress_value(self):
        self._value += self.step


class SimulatorSleepAction(SimulatorItem):
    _XML_TAG = "simulator_sleep_action"
    _XML_SCHEMA = (("sleep_time", float, 1.0),)

    def __init__(self):
        super().__init__()
        self.sleep_time = 1.0

    @property
    def caption(self):
        return "Sleep for {}s".format(self.sleep_time)


class SimulatorTriggerCommandAction(SimulatorItem):
    _XML_TAG = "simulator_trigger_command_action"
    _XML_SCHEMA = (("command", str, None), ("pass_transcript", _parse_bool_int, False))

    def __init__(self):
        super().__init__()
        self.command = None
        self.pass_transcript = False
        self.return_code = 0

    def validate(self):
        return util.validate_command(self.command)


class Transcript:
    """Round-tagged log of exchanged messages (flat entry list)."""

    FORMAT = "{0} ({1}->{2}): {3}"

    def __init__(self):
        self._entries = []  # (round, source, destination, msg, index)
        self._round = 0

    def append(self, source, destination, msg, index):
        self._entries.append((self._round, source, destination, msg, index))

    def start_new_round(self):
        if any(rnd == self._round for rnd, *_ in self._entries):
            self._round += 1

    def clear(self):
        self._entries.clear()
        self._round = 0

    def get_for_all_participants(self, all_rounds: bool, use_bit=True) -> list:
        if not self._entries:
            return []
        first_round = 0 if all_rounds else self._round
        lines = []
        previous_round = None
        for rnd, source, destination, msg, index in self._entries:
            if rnd < first_round:
                continue
            if previous_round is not None and rnd != previous_round:
                lines.append("")
            previous_round = rnd
            data = msg.plain_bits_str if use_bit else msg.plain_hex_str
            lines.append(self.FORMAT.format(index, source.shortname,
                                            destination.shortname, data))
        return lines

    def get_for_participant(self, participant) -> str:
        lines = []
        for rnd, source, destination, msg, _ in self._entries:
            if rnd != self._round:
                continue
            if participant == destination:
                lines.append("->" + msg.plain_bits_str)
            elif participant == source:
                lines.append("<-" + msg.plain_bits_str)
        return "\n".join(lines)
