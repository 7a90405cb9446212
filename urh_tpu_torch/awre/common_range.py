"""Field-range candidates produced by the awre engines.

A :class:`CommonRange` is a scored hypothesis "messages {i...} carry a
field of `field_type` at [start, start+length)" in bit/hex/byte units;
a :class:`CommonRangeContainer` groups compatible hypotheses into a
message-type candidate.  Behavioral contract: urh/awre/CommonRange.py.
"""

from __future__ import annotations

import copy
import itertools

import numpy as np

from urh_tpu_torch.coding.crc import GenericCRC

_BITS_PER_UNIT = {"bit": 1, "hex": 4, "byte": 8}


class CommonRange:
    __slots__ = ("start", "length", "values", "score", "field_type",
                 "range_type", "message_indices", "sync_end", "_byte_order")

    def __init__(self, start, length, value: np.ndarray = None, score=0,
                 field_type="Generic", message_indices=None, range_type="bit",
                 byte_order="big"):
        self.start = start
        self.length = length
        self.score = score
        self.field_type = field_type
        self.range_type = range_type.lower()
        self.sync_end = 0
        self._byte_order = byte_order
        self.message_indices = set(message_indices) if message_indices else set()

        if isinstance(value, str):
            value = np.fromiter((int(c, 16) for c in value), dtype=np.uint8,
                                count=len(value))
        self.values = [] if value is None else [value]

    # -- unit conversion ----------------------------------------------------

    def _in_bits(self, units) -> int:
        return int(units) * _BITS_PER_UNIT[self.range_type]

    @property
    def end(self):
        return self.start + self.length - 1

    @property
    def bit_start(self):
        return self._in_bits(self.start) + self.sync_end

    @property
    def bit_end(self):
        return self.bit_start + self._in_bits(self.length) - 1

    @property
    def length_in_bits(self):
        return self.bit_end - self.bit_start - 1

    # -- single-value view --------------------------------------------------

    @property
    def value(self):
        if not self.values:
            return None
        if len(self.values) > 1:
            raise ValueError("this range has multiple values")
        return self.values[0]

    @value.setter
    def value(self, val):
        if len(self.values) > 1:
            raise ValueError("this range has multiple values")
        self.values = [val]

    @property
    def byte_order(self):
        return "big" if self._byte_order is None else self._byte_order

    @byte_order.setter
    def byte_order(self, val):
        self._byte_order = val

    @property
    def byte_order_is_unknown(self) -> bool:
        return self._byte_order is None

    # -- relations ----------------------------------------------------------

    def matches(self, start: int, value: np.ndarray):
        return (start == self.start and len(value) == self.length
                and self.value.tobytes() == value.tobytes())

    def overlaps_with(self, other) -> bool:
        if not isinstance(other, CommonRange):
            raise ValueError("need another bit range to compare")
        return self.bit_start < other.bit_end and other.bit_start < self.bit_end

    def _piece(self, piece_start: int, piece_length: int):
        """Deep copy restricted to [piece_start, piece_start+piece_length)."""
        out = copy.deepcopy(self)
        out.start = piece_start
        out.length = piece_length
        shift = piece_start - self.start
        out.value = self.value[shift : shift + piece_length]
        return out

    def ensure_not_overlaps(self, start: int, end: int) -> list:
        """Pieces of this range that survive removing overlap with
        [start, end].  Case analysis matches the reference
        (CommonRange.ensure_not_overlaps) including its edge handling."""
        if end < self.start or start > self.end:
            # no overlap at all
            return [copy.deepcopy(self)]

        if start <= self.start < end < self.end:
            # overlap cuts the head: right remainder survives
            return [self._piece(end, self.length - (end - self.start))]

        if self.start < start <= self.end <= end:
            # overlap cuts the tail: left remainder survives
            return [self._piece(self.start, self.length - (self.end + 1 - start))]

        if self.start < start and self.end > end:
            # overlap strictly inside: both remainders survive
            return [self._piece(self.start, start - self.start),
                    self._piece(end + 1, self.end - end)]

        # fully covered
        return []

    # -- identity -----------------------------------------------------------

    def __eq__(self, other):
        return (isinstance(other, CommonRange)
                and (self.bit_start, self.bit_end, self.field_type)
                == (other.bit_start, other.bit_end, other.field_type))

    def __hash__(self):
        return hash((self.start, self.length, self.field_type))

    def __lt__(self, other):
        return self.bit_start < other.bit_start

    def __repr__(self):
        vals = " ".join(bytes(v).hex() for v in self.values)
        return (f"{self.field_type} {self.bit_start}-{self.bit_end}"
                f" ({self.length} {self.range_type}) Values: {vals}"
                f" Score: {self.score}"
                f" Message indices: {{{','.join(map(str, sorted(self.message_indices)))}}}")


class ChecksumRange(CommonRange):
    __slots__ = ("data_range_start", "data_range_end", "crc")

    def __init__(self, start, length, crc: GenericCRC, data_range_start,
                 data_range_end, value: np.ndarray = None, score=0,
                 field_type="Generic", message_indices=None, range_type="bit"):
        super().__init__(start, length, value, score, field_type,
                         message_indices, range_type)
        self.data_range_start = data_range_start
        self.data_range_end = data_range_end
        self.crc = crc

    @property
    def data_range_bit_start(self):
        return self.data_range_start + self.sync_end

    @property
    def data_range_bit_end(self):
        return self.data_range_end + self.sync_end

    def __eq__(self, other):
        return (super().__eq__(other)
                and isinstance(other, ChecksumRange)
                and (self.data_range_start, self.data_range_end, self.crc)
                == (other.data_range_start, other.data_range_end, other.crc))

    def __hash__(self):
        return hash((self.start, self.length, self.data_range_start,
                     self.data_range_end, self.crc))

    def __repr__(self):
        return (super().__repr__() + f" \t{self.crc.caption}"
                f" Datarange: {self.data_range_start}-{self.data_range_end} ")


class EmptyCommonRange(CommonRange):
    """Marks 'engine ran, no range found' for a field type."""

    def __init__(self, field_type="Generic"):
        super().__init__(0, 0, "", field_type=field_type)

    def __eq__(self, other):
        return (isinstance(other, EmptyCommonRange)
                and other.field_type == self.field_type)

    def __hash__(self):
        return hash(super)

    def __repr__(self):
        return "No " + self.field_type


class CommonRangeContainer:
    """A sorted bundle of ranges: the raw form of a message type."""

    def __init__(self, ranges: list, message_indices: set = None):
        assert isinstance(ranges, list)
        self._ranges = sorted(ranges)
        if message_indices is not None:
            self.message_indices = message_indices
        else:
            self.update_message_indices()

    def update_message_indices(self):
        """Intersection of all member ranges' message indices."""
        sets = [rng.message_indices for rng in self._ranges]
        self.message_indices = set.intersection(*map(set, sets)) if sets else set()

    @property
    def ranges_overlap(self) -> bool:
        return self.has_overlapping_ranges(self._ranges)

    @staticmethod
    def has_overlapping_ranges(ranges: list) -> bool:
        return any(a.overlaps_with(b) for a, b in itertools.combinations(ranges, 2))

    def add_range(self, rng: CommonRange):
        self.add_ranges([rng])

    def add_ranges(self, ranges: list):
        self._ranges = sorted(self._ranges + list(ranges))

    def has_same_ranges(self, ranges: list) -> bool:
        return self._ranges == ranges

    def has_same_ranges_as_container(self, container) -> bool:
        return (isinstance(container, CommonRangeContainer)
                and self._ranges == container._ranges)

    def __len__(self):
        return len(self._ranges)

    def __iter__(self):
        return iter(self._ranges)

    def __getitem__(self, item):
        return self._ranges[item]

    def __eq__(self, other):
        return (isinstance(other, CommonRangeContainer)
                and self._ranges == other._ranges
                and self.message_indices == other.message_indices)

    def __repr__(self):
        from pprint import pformat

        return pformat(self._ranges)
