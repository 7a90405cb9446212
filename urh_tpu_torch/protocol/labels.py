"""Protocol field model: labels, field types, message types, rulesets.

Role of urh/signalprocessing/{FieldType,ProtocoLabel,ChecksumLabel,
MessageType,Ruleset,Interval,Participant}.py, restructured around a
declarative XML layer: every model class declares ONE table of
:class:`~urh_tpu_torch.util.xmlspec.XField` specs and the generic
dump/load walk it (the reference hand-writes paired to_xml/from_xml on
each class).  The wire format stays attribute-compatible with
reference project files.

A label is a named [start, end) bit range with a semantic function; a
message type is a sorted label list plus an assignment ruleset;
checksum labels carry a GenericCRC/WSPChecksum and data ranges.
"""

from __future__ import annotations

import array
import ast
import copy
import operator
import random
import uuid
import xml.etree.ElementTree as ET
from enum import Enum
from typing import NamedTuple

from urh_tpu_torch.coding.crc import GenericCRC
from urh_tpu_torch.coding.wsp import WSPChecksum
from urh_tpu_torch.util.xmlspec import XField, dump, load

NUM_LABEL_COLORS = 32  # palette size used for auto color assignment


class Interval(NamedTuple):
    """Half-open [start, end) index interval."""

    start: int
    end: int

    @property
    def data(self):
        return tuple(self)

    def range(self):
        return range(self.start, self.end)

    def __repr__(self):
        return f"{self.start}-{self.end}"

    def overlaps_with(self, other) -> bool:
        return self.start < other.end and other.start < self.end

    def find_common_interval(self, other):
        """Largest interval contained in both, None when disjoint
        (Interval.py:41-50)."""
        lo, hi = max(self.start, other.start), min(self.end, other.end)
        return Interval(lo, hi) if lo < hi else None

    @staticmethod
    def find_greatest(intervals: list) -> "Interval":
        return max(intervals, key=len)


class FieldType:
    __slots__ = ["caption", "function", "display_format_index"]

    class Function(Enum):
        PREAMBLE = "preamble"
        SYNC = "synchronization"
        LENGTH = "length"
        SRC_ADDRESS = "source address"
        DST_ADDRESS = "destination address"
        SEQUENCE_NUMBER = "sequence number"
        TYPE = "type"
        DATA = "data"
        CHECKSUM = "checksum"
        CUSTOM = "custom"

    # default display: 1 = hex for addresses/checksums, 3 = decimal for
    # counters, 0 = bit for everything else
    _DEFAULT_DISPLAY = {
        Function.DST_ADDRESS: 1, Function.SRC_ADDRESS: 1,
        Function.CHECKSUM: 1,
        Function.SEQUENCE_NUMBER: 3, Function.LENGTH: 3,
    }

    def __init__(self, caption: str, function: Function,
                 display_format_index: int = None):
        self.caption = caption
        self.function = function
        self.display_format_index = (
            self._DEFAULT_DISPLAY.get(function, 0)
            if display_format_index is None else display_format_index)

    def __eq__(self, other):
        return (isinstance(other, FieldType) and self.caption == other.caption
                and self.function == other.function)

    def __repr__(self):
        return "FieldType: {0} - {1} ({2})".format(
            self.function.name, self.caption, self.display_format_index)

    @staticmethod
    def from_caption(caption: str):
        try:
            return FieldType(caption, FieldType.Function(caption))
        except ValueError:
            return None

    @staticmethod
    def default_field_types():
        return [FieldType(f.value, f) for f in FieldType.Function]

    def to_xml(self):
        return dump("field_type", self, (
            XField("caption"),
            XField("function", obj_attr="_function_name"),
            XField("display_format_index", "int"),
        ))

    @property
    def _function_name(self):
        return self.function.name

    @staticmethod
    def from_xml(tag):
        name = tag.get("function", "CUSTOM")
        if name == "CRC":  # legacy project files
            name = "CHECKSUM"
        function = getattr(FieldType.Function, name, FieldType.Function.CUSTOM)
        dfi = int(tag.get("display_format_index", -1))
        return FieldType(tag.get("caption", ""), function,
                         None if dfi == -1 else dfi)


# XML spec shared by ProtocolLabel.to_xml / from_xml (ChecksumLabel
# extends it); start/end/name/field type resolution happen around it
# because they are asymmetric in the reference wire format.
_LABEL_XML_FIELDS = (
    XField("apply_decoding", "bool", default=True),
    XField("show", "bool01", default=False),  # reference: absent == unchecked
    XField("display_format_index", "int", default=0),
    XField("display_bit_order_index", "int", default=0),
    XField("display_endianness", default="big"),
    XField("fuzz_me", "bool01", default=False),
    XField("fuzz_values", "csv", default=None),
    XField("auto_created", "bool", default=False),
)


class ProtocolLabel:
    """A named [start, end) bit range with a semantic field function.

    NOTE: the constructor takes an INCLUSIVE end (reference convention,
    ProtocoLabel.py:53); the stored ``end`` is exclusive.
    """

    DISPLAY_FORMATS = ["Bit", "Hex", "ASCII", "Decimal", "BCD"]
    DISPLAY_BIT_ORDERS = ["MSB", "LSB", "LSD"]
    SEARCH_TYPES = ["Number", "Bits", "Hex", "ASCII"]

    __slots__ = ("_name", "start", "end", "apply_decoding", "color_index", "show",
                 "_fuzz_me", "fuzz_values", "fuzz_created", "_field_type",
                 "display_format_index", "display_bit_order_index",
                 "display_endianness", "auto_created", "copied")

    def __init__(self, name: str, start: int, end: int, color_index: int,
                 fuzz_created=False, auto_created=False, field_type: FieldType = None):
        self._name = name
        self.start = start
        self.end = end + 1

        self.apply_decoding = True
        self.color_index = color_index
        self.show = True
        self._fuzz_me = True
        self.fuzz_values = []
        self.fuzz_created = fuzz_created

        if field_type is None:
            self._field_type = FieldType.from_caption(name)
            self.display_format_index = 0
        else:
            self._field_type = field_type
            self.display_format_index = field_type.display_format_index
        self.display_bit_order_index = 0
        self.display_endianness = "big"
        self.auto_created = auto_created
        self.copied = False  # copy-on-write marker for generation

    @property
    def name(self):
        if not self._name:
            self._name = "No name"
        return self._name

    @name.setter
    def name(self, val):
        if val:
            self._name = val

    @property
    def fuzz_me(self):
        return self._fuzz_me

    @fuzz_me.setter
    def fuzz_me(self, value):
        self._fuzz_me = value == "True" if isinstance(value, str) else bool(value)

    @property
    def field_type(self) -> FieldType:
        return self._field_type

    @field_type.setter
    def field_type(self, value: FieldType):
        if value != self._field_type:
            self._field_type = value
            if hasattr(value, "display_format_index"):
                self.display_format_index = value.display_format_index

    @property
    def field_type_function(self):
        return None if self._field_type is None else self._field_type.function

    @property
    def is_preamble(self) -> bool:
        return self.field_type_function == FieldType.Function.PREAMBLE

    @property
    def is_sync(self) -> bool:
        return self.field_type_function == FieldType.Function.SYNC

    @property
    def length(self) -> int:
        return self.end - self.start

    @property
    def fuzz_maximum(self):
        return 1 << self.length

    @property
    def active_fuzzing(self) -> bool:
        return bool(self.fuzz_me) and len(self.fuzz_values) > 1

    @property
    def range_complete_fuzzed(self) -> bool:
        return len(self.fuzz_values) == self.fuzz_maximum

    def get_copy(self):
        if self.copied:
            return self
        clone = copy.deepcopy(self)
        clone.copied = True
        return clone

    def __lt__(self, other):
        if self.start != other.start:
            return self.start < other.start
        if self.end != other.end:
            return self.end < other.end
        if self.name is not None and other.name is not None:
            return len(self.name) < len(other.name)
        return False

    def __eq__(self, other):
        return (self.start == other.start and self.end == other.end
                and self.name == other.name
                and self.field_type_function == other.field_type_function)

    def __hash__(self):
        return hash((self.start, self.end, self.name, self.field_type_function))

    def __repr__(self):
        return "Protocol Label - start: {0} end: {1} name: {2}".format(
            self.start, self.end, self.name)

    def overlaps_with(self, other_label) -> bool:
        return Interval(self.start, self.end).overlaps_with(
            Interval(other_label.start, other_label.end))

    def add_fuzz_value(self):
        width = len(self.fuzz_values[-1])
        succ = (int(self.fuzz_values[-1], 2) + 1) % (1 << width)
        self.fuzz_values.append(format(succ, f"0{width}b"))

    def add_decimal_fuzz_value(self, val: int):
        width = len(self.fuzz_values[-1])
        self.fuzz_values.append(format(val, f"0{width}b"))

    def to_xml(self) -> ET.Element:
        elem = dump("label", self, _LABEL_XML_FIELDS)
        elem.set("name", self._name)
        elem.set("start", str(self.start))
        elem.set("end", str(self.end))
        elem.set("color_index", str(self.color_index))
        elem.set("fuzz_me", str(int(bool(self.fuzz_me))))
        return elem

    @classmethod
    def from_xml(cls, tag: ET.Element, field_types_by_caption=None):
        result = ProtocolLabel(
            name=tag.get("name"),
            start=int(tag.get("start", 0)),
            end=int(tag.get("end", 0)) - 1,
            color_index=int(tag.get("color_index", 0)))
        load(result, tag, _LABEL_XML_FIELDS)
        if result.fuzz_values is None:
            result.fuzz_values = [""]  # "".split(",") reference artifact
        result.field_type = (field_types_by_caption or {}).get(result.name)
        # field_type assignment may override the serialized display format
        dfi = tag.get("display_format_index")
        if dfi is not None:
            result.display_format_index = int(dfi)
        return result


class ChecksumLabel(ProtocolLabel):
    __slots__ = ("_data_ranges", "checksum", "_category")

    class Category(Enum):
        generic = "generic"
        wsp = "Wireless Short Packet (WSP)"

    _CHECKSUMS_BY_CATEGORY = {Category.generic: GenericCRC,
                              Category.wsp: WSPChecksum}

    def __init__(self, name: str, start: int, end: int, color_index: int,
                 field_type: FieldType, fuzz_created=False, auto_created=False,
                 data_range_start=0):
        assert field_type.function == FieldType.Function.CHECKSUM
        super().__init__(name, start, end, color_index, fuzz_created,
                         auto_created, field_type)
        self._category = self.Category.generic
        self._data_ranges = [[data_range_start, self.start]]
        self.checksum = GenericCRC(polynomial=0)

    def calculate_checksum(self, bits) -> array.array:
        return self.checksum.calculate(bits)

    def calculate_checksum_for_message(self, message, use_decoded_bits: bool) -> array.array:
        bits = message.decoded_bits if use_decoded_bits else message.plain_bits
        data = array.array("B", [])
        for lo, hi in self.data_ranges:
            data.extend(bits[lo:hi])
        return self.calculate_checksum(data)

    @property
    def data_ranges(self):
        # WSP checksums always cover [12, -4) by specification
        return [[12, -4]] if self.category == self.Category.wsp else self._data_ranges

    @data_ranges.setter
    def data_ranges(self, value):
        self._data_ranges = value

    @property
    def is_generic_crc(self):
        return self.category == self.Category.generic

    @property
    def category(self) -> "ChecksumLabel.Category":
        return self._category

    @category.setter
    def category(self, value):
        if value == self._category:
            return
        try:
            checksum_cls = self._CHECKSUMS_BY_CATEGORY[value]
        except KeyError:
            raise ValueError("unknown category")
        self._category = value
        self.checksum = checksum_cls()

    _CONVERT_ATTRS = ("apply_decoding", "show", "fuzz_me", "fuzz_values",
                      "display_format_index")

    def to_label(self, field_type: FieldType) -> ProtocolLabel:
        result = ProtocolLabel(name=self.name, start=self.start, end=self.end - 1,
                               color_index=self.color_index, field_type=field_type,
                               auto_created=self.auto_created,
                               fuzz_created=self.fuzz_created)
        for attr in self._CONVERT_ATTRS:
            setattr(result, attr, getattr(self, attr))
        return result

    @classmethod
    def from_label(cls, label: ProtocolLabel):
        result = cls(name=label.name, start=label.start, end=label.end - 1,
                     color_index=label.color_index,
                     field_type=FieldType(label.name, FieldType.Function.CHECKSUM),
                     fuzz_created=label.fuzz_created,
                     auto_created=label.auto_created)
        for attr in cls._CONVERT_ATTRS:
            setattr(result, attr, getattr(label, attr))
        return result

    @classmethod
    def from_xml(cls, tag: ET.Element, field_types_by_caption=None):
        field_types_by_caption = field_types_by_caption or {}
        lbl = ProtocolLabel.from_xml(tag, field_types_by_caption)
        if (lbl.field_type is None
                or lbl.field_type.function != FieldType.Function.CHECKSUM):
            lbl.field_type = next(
                (ft for ft in field_types_by_caption.values()
                 if ft.function == FieldType.Function.CHECKSUM),
                FieldType("checksum", FieldType.Function.CHECKSUM,
                          display_format_index=1))
        result = cls.from_label(lbl)
        result.data_ranges = ast.literal_eval(tag.get("data_ranges", "[]"))
        result.category = cls.Category[tag.get("category", "generic")]
        for child_tag, loader in (("crc", GenericCRC.from_xml),
                                  ("wsp_checksum", WSPChecksum.from_xml)):
            child = tag.find(child_tag)
            if child is not None:
                result.checksum = loader(child)
        return result

    def to_xml(self):
        elem = super().to_xml()
        elem.tag = "checksum_label"
        elem.set("data_ranges", str(self.data_ranges))
        elem.set("category", self.category.name)
        elem.append(self.checksum.to_xml())
        return elem


# ---------------------------------------------------------------------------
# Rulesets (message-type auto assignment)
# ---------------------------------------------------------------------------

OPERATIONS = {
    ">": operator.gt, "<": operator.lt, ">=": operator.ge,
    "<=": operator.le, "=": operator.eq, "!=": operator.ne,
}

OPERATION_DESCRIPTION = {
    ">": "greater", "<": "lower", ">=": "greater equal",
    "<=": "lower equal", "=": "equal", "!=": "not equal",
}


class Mode(Enum):
    all_apply = 0
    atleast_one_applies = 1
    none_applies = 2


# mode -> predicate over (number of applying rules, number of rules)
_MODE_PREDICATES = {
    Mode.all_apply: lambda hits, total: hits == total,
    Mode.atleast_one_applies: lambda hits, total: hits > 0,
    Mode.none_applies: lambda hits, total: hits == 0,
}

_RULE_XML_FIELDS = (
    XField("_start", "int", default=-1),
    XField("_end", "int", default=-1),
    XField("_value_type", "int", default=0),
    XField("operator", default="="),
    XField("target_value", default=""),
)


class _CoercedInt:
    """Descriptor: public int view over a string-tolerant private slot
    (project XML delivers these as strings)."""

    def __set_name__(self, owner, name):
        self.slot = "_" + name

    def __get__(self, obj, objtype=None):
        return self if obj is None else int(getattr(obj, self.slot))

    def __set__(self, obj, value):
        setattr(obj, self.slot, int(value))


class Rule:
    # value_type index -> message attribute holding the comparable view
    _VIEWS = ("decoded_bits_str", "decoded_hex_str", "decoded_ascii_str")

    start = _CoercedInt()
    end = _CoercedInt()
    value_type = _CoercedInt()  # 0 = Bit, 1 = Hex, 2 = ASCII

    def __init__(self, start: int, end: int, operator: str, target_value: str,
                 value_type: int):
        assert operator in OPERATIONS
        self._start = start
        self._end = end + 1
        self._value_type = value_type
        self.operator = operator
        self.target_value = target_value

    def applies_for_message(self, message):
        view = getattr(message, self._VIEWS[self.value_type])
        return OPERATIONS[self.operator](view[self.start:self.end],
                                         self.target_value)

    @property
    def operator_description(self):
        return OPERATION_DESCRIPTION[self.operator]

    @operator_description.setter
    def operator_description(self, value):
        matches = [op for op, desc in OPERATION_DESCRIPTION.items() if desc == value]
        if matches:
            self.operator = matches[0]

    def to_xml(self) -> ET.Element:
        return dump("rule", self, _RULE_XML_FIELDS)

    @staticmethod
    def from_xml(tag: ET.Element):
        result = Rule(start=-1, end=-1, operator="=", target_value="", value_type=0)
        load(result, tag, _RULE_XML_FIELDS)
        return result


class Ruleset(list):
    def __init__(self, mode: Mode = Mode.all_apply, rules=None):
        super().__init__(rules if rules is not None else [])
        self.mode = mode

    def applies_for_message(self, message):
        hits = sum(rule.applies_for_message(message) for rule in self)
        try:
            return _MODE_PREDICATES[self.mode](hits, len(self))
        except KeyError:
            raise ValueError("unknown mode")

    def to_xml(self) -> ET.Element:
        root = ET.Element("ruleset", attrib={"mode": str(self.mode.value)})
        root.extend(rule.to_xml() for rule in self)
        return root

    @staticmethod
    def from_xml(tag: ET.Element):
        # reference semantics: a ruleset tag without child rules falls back
        # to the default ruleset
        if tag is None or len(tag) == 0:
            return Ruleset(mode=Mode.all_apply)
        return Ruleset(mode=Mode(int(tag.get("mode", 0))),
                       rules=map(Rule.from_xml, tag.findall("rule")))


class MessageType(list):
    """A sorted list of protocol labels plus an assignment ruleset."""

    __slots__ = ["name", "show", "_id", "assigned_by_ruleset", "ruleset",
                 "assigned_by_logic_analyzer"]

    def __init__(self, name: str, iterable=None, id=None, ruleset=None):
        super().__init__(iterable if iterable else [])
        self.name = name
        self.show = True
        self._id = str(uuid.uuid4()) if id is None else id
        self.assigned_by_logic_analyzer = False
        self.assigned_by_ruleset = False
        self.ruleset = Ruleset() if ruleset is None else ruleset

    def __hash__(self):
        return hash(super)

    def __repr__(self):
        return self.name + " " + super().__repr__()

    def __eq__(self, other):
        if isinstance(other, MessageType):
            return self.id == other.id
        return super().__eq__(other)

    @property
    def assign_manually(self):
        return not self.assigned_by_ruleset

    @property
    def id(self) -> str:
        return self._id

    def give_new_id(self):
        self._id = str(uuid.uuid4())

    @property
    def checksum_labels(self) -> list:
        return [lbl for lbl in self if isinstance(lbl, ChecksumLabel)]

    @property
    def unlabeled_ranges(self):
        return self._unlabeled_ranges_from_labels(self)

    @staticmethod
    def _unlabeled_ranges_from_labels(labels):
        """Gaps between sorted labels: (0, l0.start), (l0.end, l1.start),
        ..., (last.end, None)."""
        bounds = [0] + [b for lbl in labels for b in (lbl.start, lbl.end)] + [None]
        gaps = zip(bounds[::2], bounds[1::2])
        return [(lo, hi) for lo, hi in gaps if hi is None or lo < hi]

    def unlabeled_ranges_with_other_mt(self, other_message_type):
        return self._unlabeled_ranges_from_labels(
            sorted(list(self) + list(other_message_type)))

    def get_first_label_with_type(self, field_type: FieldType.Function) -> ProtocolLabel:
        return next((lbl for lbl in self
                     if lbl.field_type and lbl.field_type.function == field_type), None)

    def num_labels_with_type(self, field_type: FieldType.Function) -> int:
        return sum(1 for lbl in self
                   if lbl.field_type and lbl.field_type.function == field_type)

    def append(self, lbl: ProtocolLabel):
        super().append(lbl)
        self.sort()

    def _create_label(self, name, start, end, color_index, auto_created, field_type):
        if field_type is None or field_type.function != FieldType.Function.CHECKSUM:
            return ProtocolLabel(name=name, start=start, end=end,
                                 color_index=color_index,
                                 field_type=field_type, auto_created=auto_created)
        # checksum data range starts behind preamble/sync if present
        framing_ends = [lbl.end for lbl in self if lbl.is_preamble or lbl.is_sync]
        range_start = max(framing_ends, default=0)
        if range_start >= start:
            range_start = 0
        return ChecksumLabel(name=name, start=start, end=end,
                             color_index=color_index, field_type=field_type,
                             auto_created=auto_created,
                             data_range_start=range_start)

    def _pick_color(self) -> int:
        taken = {lbl.color_index for lbl in self}
        free = [i for i in range(NUM_LABEL_COLORS) if i not in taken]
        return free[0] if free else random.randint(0, NUM_LABEL_COLORS - 1)

    def add_protocol_label(self, start: int, end: int, name=None, color_ind=None,
                           auto_created=False, type: FieldType = None) -> ProtocolLabel:
        proto_label = self._create_label(
            name or "", start, end,
            self._pick_color() if color_ind is None else color_ind,
            auto_created, type)
        if proto_label not in self:
            self.append(proto_label)
            self.sort()
        return proto_label

    def add_protocol_label_start_length(self, start: int, length: int, name=None,
                                        color_ind=None, auto_created=False,
                                        type: FieldType = None) -> ProtocolLabel:
        return self.add_protocol_label(start, start + length - 1, name, color_ind,
                                       auto_created, type)

    def add_label(self, lbl: ProtocolLabel, allow_overlapping=True):
        if not allow_overlapping and any(lbl.overlaps_with(o) for o in self):
            return
        added = self.add_protocol_label(lbl.start, lbl.end - 1, name=lbl.name,
                                        color_ind=lbl.color_index,
                                        type=lbl.field_type)
        added.display_format_index = lbl.display_format_index
        added.display_bit_order_index = lbl.display_bit_order_index
        if isinstance(lbl, ChecksumLabel) and isinstance(added, ChecksumLabel):
            for attr in ("data_ranges", "category", "checksum"):
                setattr(added, attr, copy.copy(getattr(lbl, attr)))

    def remove(self, lbl: ProtocolLabel):
        if lbl in self:
            super().remove(lbl)

    def change_field_type_of_label(self, label: ProtocolLabel, field_type: FieldType):
        if not isinstance(label, ProtocolLabel) and hasattr(label, "field_type"):
            label.field_type = field_type
            return
        wants_checksum = (field_type is not None
                          and field_type.function == FieldType.Function.CHECKSUM)
        if wants_checksum == isinstance(label, ChecksumLabel):
            label.field_type = field_type
        else:  # class must change: rebuild in place
            self[self.index(label)] = self._create_label(
                label.name, label.start, label.end - 1, label.color_index,
                label.auto_created, field_type)

    def to_xml(self) -> ET.Element:
        result = ET.Element("message_type", attrib={
            "name": self.name,
            "id": self.id,
            "assigned_by_ruleset": str(int(bool(self.assigned_by_ruleset))),
            "assigned_by_logic_analyzer": str(int(bool(self.assigned_by_logic_analyzer))),
        })
        result.extend(lbl.to_xml() for lbl in self)
        result.append(self.ruleset.to_xml())
        return result

    @staticmethod
    def from_xml(tag: ET.Element):
        types_by_caption = {ft.caption: ft for ft in FieldType.default_field_types()}
        labels = [ProtocolLabel.from_xml(t, types_by_caption)
                  for t in tag.findall("label")]
        labels += [ChecksumLabel.from_xml(t, types_by_caption)
                   for t in tag.findall("checksum_label")]
        result = MessageType(name=tag.get("name", "blank"), iterable=labels,
                             id=tag.get("id", None),
                             ruleset=Ruleset.from_xml(tag.find("ruleset")))
        result.assigned_by_ruleset = bool(int(tag.get("assigned_by_ruleset", 0)))
        result.assigned_by_logic_analyzer = bool(
            int(tag.get("assigned_by_logic_analyzer", 0)))
        return result


_PARTICIPANT_XML_FIELDS = (
    XField("name", default="Empty"),
    XField("shortname", default="X"),
    XField("address_hex", default=""),
    XField("color_index", "int", default=0),
    XField("relative_rssi", "int", default=0),
    XField("simulate", "bool01", default=False),
)


class Participant:
    __slots__ = ["name", "shortname", "address_hex", "color_index", "show",
                 "simulate", "relative_rssi", "_id"]

    def __init__(self, name: str, shortname: str = None, address_hex: str = None,
                 color_index=0, id: str = None, relative_rssi=0, simulate=False):
        self.name = name or "unknown"
        self.shortname = shortname or (name[:1].upper() or "X")
        self.address_hex = address_hex or ""
        self.color_index = color_index
        self.show = True
        self.simulate = simulate
        self.relative_rssi = relative_rssi
        self._id = str(uuid.uuid4()) if id is None else id

    def __eq__(self, other):
        return isinstance(other, Participant) and self.id_match(other.id)

    @property
    def id(self):
        return self._id

    def __repr__(self):
        suffix = f" [{self.address_hex}]" if self.address_hex else ""
        return f"{self.name} ({self.shortname}){suffix}"

    def __str__(self):
        return repr(self)

    def id_match(self, id):
        return self._id == id

    def __hash__(self):
        return hash(self.id)

    def __lt__(self, other):
        return isinstance(other, Participant) and self.shortname < other.shortname

    @staticmethod
    def find_matching(participant_id: str, participants: list):
        return next((p for p in participants if p.id_match(participant_id)), None)

    def to_xml(self) -> ET.Element:
        elem = dump("participant", self, _PARTICIPANT_XML_FIELDS)
        elem.set("id", str(self.id))
        return elem

    @staticmethod
    def from_xml(tag: ET.Element):
        result = Participant("Empty", id=tag.attrib["id"])
        load(result, tag, _PARTICIPANT_XML_FIELDS)
        return result

    @staticmethod
    def participants_to_xml_tag(participants: list) -> ET.Element:
        root = ET.Element("participants")
        root.extend(p.to_xml() for p in participants)
        return root

    @staticmethod
    def read_participants_from_xml_tag(xml_tag: ET.Element):
        if xml_tag is not None and xml_tag.tag != "participants":
            xml_tag = xml_tag.find("participants")
        if xml_tag is None:
            return []
        return [Participant.from_xml(tag) for tag in xml_tag.findall("participant")]
