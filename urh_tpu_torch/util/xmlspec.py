"""Declarative XML (de)serialization.

The reference hand-writes paired ``to_xml``/``from_xml`` methods on
every model class (labels, rulesets, message types, participants, ...),
each repeating attribute-by-attribute string conversion.  Here a class
declares ONE table of :class:`XField` specs and the generic
:func:`dump`/:func:`load` walk it, so encoding, decoding, and defaults
can never drift apart.  The produced XML stays attribute-compatible
with the reference's project format.

Codecs convert python value <-> XML attribute string:

  int / float / str  — str() / constructor
  bool               — "True"/"False" text (reference bool style)
  bool01             — "1"/"0" ints (reference int-bool style)
  csv                — list of strings <-> comma-joined
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass


def _parse_bool(text: str) -> bool:
    return text == "True"


def _parse_bool01(text: str) -> bool:
    return bool(int(text))  # malformed flags fall back to the field default


_ENCODERS = {
    "int": lambda v: str(int(v)),
    "float": lambda v: str(v),
    "str": lambda v: str(v),
    "bool": lambda v: str(bool(v)),
    "bool01": lambda v: str(int(bool(v))),
    "csv": lambda v: ",".join(v),
}

_DECODERS = {
    "int": int,
    "float": float,
    "str": str,
    "bool": _parse_bool,
    "bool01": _parse_bool01,
    "csv": lambda text: text.split(","),
}


@dataclass(frozen=True)
class XField:
    attr: str            # XML attribute name
    codec: str = "str"   # key into the codec tables
    obj_attr: str = None  # python attribute when it differs from `attr`
    default: object = None  # used by load() when the attribute is absent

    @property
    def target(self) -> str:
        return self.obj_attr if self.obj_attr is not None else self.attr


def dump(tag_name: str, obj, fields) -> ET.Element:
    """Serialize obj's declared fields into a new element."""
    elem = ET.Element(tag_name)
    for f in fields:
        elem.set(f.attr, _ENCODERS[f.codec](getattr(obj, f.target)))
    return elem


def load(obj, elem: ET.Element, fields) -> None:
    """Populate obj from an element, falling back to each field's default."""
    for f in fields:
        text = elem.get(f.attr)
        if text is None:
            value = f.default
        else:
            try:
                value = _DECODERS[f.codec](text)
            except (ValueError, TypeError):
                value = f.default
        setattr(obj, f.target, value)
