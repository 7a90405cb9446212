"""Protocol message: one demodulated line (bits + metadata), array-backed.

Functional counterpart of the reference's Message
(urh/signalprocessing/Message.py) with a different data model:

* bits live in a NumPy uint8 bit-plane (:class:`Bits`) with list-like
  mutation on top, so views and codecs are vectorized instead of
  per-element Python loops;
* label-aware decode/encode is driven by an explicit segment table
  (``_codec_segments``) — alternating coded / passthrough spans — rather
  than a running-cursor loop;
* hex/ASCII views are group reductions (reshape + weight dot) over those
  segments;
* bit <-> hex/ASCII index conversion uses a precomputed cumulative
  character-offset table per alignment segment (:class:`_AlignmentIndex`)
  queried with ``searchsorted`` — O(log n) per lookup in both directions,
  replacing the reference's O(N^2) linear scan (Message.py:356-424).

View ids follow the reference convention: 0=bit, 1=hex, 2=ASCII.
"""

from __future__ import annotations

import array
import xml.etree.ElementTree as ET

import numpy as np

from urh_tpu_torch.protocol.labels import FieldType, MessageType, Participant, ProtocolLabel

_HEX_DIGITS = np.array(list("0123456789abcdef"))


class Bits:
    """Mutable bit vector over a NumPy uint8 plane.

    Supports the handful of list-isms the framework uses (concat via
    ``+``, slice get/set including length-changing assignment, insert,
    delete, value equality with any bit sequence) while exposing the
    underlying ndarray for vectorized work.  An optional ``on_mutate``
    callback lets the owning message drop its caches whenever the buffer
    changes through any path.
    """

    __slots__ = ("_plane", "_on_mutate")

    def __init__(self, values=(), on_mutate=None):
        self._plane = self._coerce(values)
        self._on_mutate = on_mutate

    @staticmethod
    def _coerce(values) -> np.ndarray:
        if isinstance(values, Bits):
            return values._plane.copy()
        if isinstance(values, np.ndarray):
            return values.astype(np.uint8).reshape(-1).copy()
        if isinstance(values, str):
            plane = np.frombuffer(values.encode(), np.uint8) - ord("0")
            if plane.size and plane.max(initial=0) > 1:
                raise ValueError(f"invalid bit string: {values[:32]!r}")
            return plane
        return np.array([int(v) for v in values], dtype=np.uint8)

    # -- array access ------------------------------------------------------
    @property
    def plane(self) -> np.ndarray:
        """The raw uint8 ndarray (do not mutate in place)."""
        return self._plane

    def __array__(self, dtype=None, copy=None):
        return self._plane if dtype is None else self._plane.astype(dtype)

    def _mutated(self):
        if self._on_mutate is not None:
            self._on_mutate()

    def _replace(self, plane: np.ndarray):
        self._plane = plane.astype(np.uint8).reshape(-1)
        self._mutated()

    # -- sequence protocol ---------------------------------------------------
    def __len__(self):
        return int(self._plane.shape[0])

    def __iter__(self):
        return iter(self._plane.tolist())

    def __getitem__(self, index):
        if isinstance(index, slice):
            return Bits(self._plane[index])
        return int(self._plane[index])

    def __setitem__(self, index, value):
        if isinstance(index, slice):
            new = self._coerce(value)
            start, stop, step = index.indices(len(self))
            if step == 1 and len(new) != stop - start:
                # length-changing splice (array.array semantics)
                self._replace(np.concatenate(
                    [self._plane[:start], new, self._plane[stop:]]))
                return
            self._plane[index] = new
        else:
            self._plane[index] = int(value)
        self._mutated()

    def __delitem__(self, index):
        keep = np.ones(len(self), dtype=bool)
        keep[index] = False
        self._replace(self._plane[keep])

    def insert(self, index: int, value):
        self._replace(np.insert(self._plane, index, int(value)))

    def extend(self, values):
        new = self._coerce(values)
        if len(new):
            self._replace(np.concatenate([self._plane, new]))

    def append(self, value):
        self.insert(len(self), value)

    def __add__(self, other):
        return Bits(np.concatenate([self._plane, self._coerce(other)]))

    def __radd__(self, other):
        return Bits(np.concatenate([self._coerce(other), self._plane]))

    def __eq__(self, other):
        try:
            other_plane = self._coerce(other)
        except (TypeError, ValueError):
            return NotImplemented
        return (len(other_plane) == len(self._plane)
                and bool(np.array_equal(self._plane, other_plane)))

    def __hash__(self):
        return hash(self._plane.tobytes())

    def tobytes(self) -> bytes:
        return self._plane.tobytes()

    def tolist(self) -> list:
        return self._plane.tolist()

    def copy(self) -> "Bits":
        return Bits(self._plane)

    __copy__ = copy

    def __deepcopy__(self, memo):
        return Bits(self._plane)

    def __str__(self):
        return "".join(map(str, self._plane.tolist()))

    def __repr__(self):
        return f"Bits({str(self)!r})"


def _group_reduce(chunks, width: int) -> np.ndarray:
    """Each chunk of bits -> MSB-first symbols of ``width`` bits, chunks
    zero-padded independently to a multiple of ``width`` (this is what
    makes hex/ASCII views align at label boundaries)."""
    weights = (1 << np.arange(width - 1, -1, -1)).astype(np.int64)
    parts = []
    for chunk in chunks:
        bits = np.asarray(chunk, dtype=np.int64).reshape(-1)
        pad = (-len(bits)) % width
        if pad:
            bits = np.concatenate([bits, np.zeros(pad, np.int64)])
        if len(bits):
            parts.append(bits.reshape(-1, width) @ weights)
    if not parts:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(parts).astype(np.uint8)


class _AlignmentIndex:
    """Bit index <-> character index mapping for one alignment layout.

    ``alignments`` are the sorted label boundary positions; each segment
    between consecutive boundaries renders independently, padded up to a
    whole number of ``factor``-bit characters.  The cumulative character
    start of every segment is precomputed, so both directions are a
    ``searchsorted`` plus arithmetic.
    """

    __slots__ = ("factor", "n_bits", "starts", "char0")

    def __init__(self, alignments, factor: int, n_bits: int):
        self.factor = factor
        self.n_bits = n_bits
        starts = np.unique(np.asarray([0, *alignments], dtype=np.int64))
        self.starts = starts
        seg_len = np.diff(starts)
        chars = -(-seg_len // factor)  # ceil division
        self.char0 = np.concatenate([[0], np.cumsum(chars)])

    def char_of(self, bit_index: int) -> int:
        k = int(np.searchsorted(self.starts, bit_index, side="right")) - 1
        return int(self.char0[k] + (bit_index - self.starts[k]) // self.factor)

    def bit_range_of(self, char_index: int):
        """First bit rendering into character ``char_index`` (and the last
        bit of a full character cell), or None when the character is
        padding / past the message."""
        k = int(np.searchsorted(self.char0, char_index, side="right")) - 1
        if k >= len(self.starts):
            return None
        bit = int(self.starts[k] + (char_index - self.char0[k]) * self.factor)
        seg_end = int(self.starts[k + 1]) if k + 1 < len(self.starts) else self.n_bits
        if bit >= min(seg_end, self.n_bits):
            return None
        return bit, bit + self.factor - 1


class Message:
    """One protocol line: bit-plane + pause/timestamp/RSSI/participant,
    a decoder, and a message type carrying the labels."""

    def __init__(self, plain_bits, pause: int, message_type: MessageType = None,
                 rssi=0.0, modulator_index=0, decoder=None, fuzz_created=False,
                 bit_sample_pos=None, bits_per_symbol=1, samples_per_symbol=100,
                 timestamp=0.0, participant=None):
        self._bits = Bits(plain_bits, on_mutate=self._invalidate)
        self.pause = int(pause)
        self.message_type = message_type if message_type is not None else MessageType("none")
        self.rssi = float(rssi)
        self.modulator_index = modulator_index
        self.fuzz_created = fuzz_created
        self.bit_sample_pos = bit_sample_pos if bit_sample_pos is not None else array.array("L", [])
        self.bits_per_symbol = bits_per_symbol
        self.samples_per_symbol = samples_per_symbol
        self.timestamp = timestamp
        self.participant = participant

        self.align_labels = True
        self.alignment_offset = 0
        self._bit_alignments = []

        self._decoded = None
        self._encoded = None
        self.decoding_state = "success"
        self.decoding_errors = 0
        self._decoder = None
        if decoder is not None:
            self.decoder = decoder

    def _invalidate(self):
        self._decoded = None
        self._encoded = None

    # -- bits ------------------------------------------------------------
    @property
    def plain_bits(self) -> Bits:
        return self._bits

    @plain_bits.setter
    def plain_bits(self, value):
        self._bits = Bits(value, on_mutate=self._invalidate)
        self._invalidate()

    @property
    def active_fuzzing_labels(self):
        return [lbl for lbl in self.message_type if lbl.active_fuzzing]

    @property
    def exclude_from_decoding_labels(self):
        return [lbl for lbl in self.message_type if not lbl.apply_decoding]

    def __getitem__(self, index):
        return self._bits[index]

    def __setitem__(self, index, value):
        self._bits[index] = value

    def __add__(self, other):
        return self._bits + other._bits

    def __len__(self):
        return len(self._bits)

    def __str__(self):
        return str(self._bits)

    def __repr__(self):
        return f"Message({self.plain_bits_str!r}, pause={self.pause})"

    @staticmethod
    def bits2string(bits) -> str:
        return "".join(str(int(b)) for b in bits)

    def insert(self, index: int, item):
        self._bits.insert(index, item)

    def _remove_labels_for_range(self, index, instant_remove=True):
        """Labels touched by a bit-range deletion are dropped; labels fully
        behind it shift left (reference semantics, Message.py:152-185)."""
        if isinstance(index, int):
            index = slice(index, index + 1, 1)
        start, stop, step = index.start or 0, index.stop, index.step or 1
        removed_count = len(range(start, stop, step))

        hit, shifted = [], []
        for lbl in self.message_type:
            overlaps = lbl.start < stop and lbl.end > start
            if overlaps or start <= lbl.start <= stop:
                hit.append(lbl)
            elif lbl.start >= stop:
                moved = lbl.get_copy()
                moved.start -= removed_count
                moved.end -= removed_count
                shifted.append((lbl, moved))
        if instant_remove:
            for lbl in hit:
                self.message_type.remove(lbl)
            for old, new in shifted:
                self.message_type.remove(old)
                self.message_type.append(new)
        return hit

    def __delitem__(self, index):
        self._remove_labels_for_range(index)
        del self._bits[index]

    def delete_range_without_label_range_update(self, start: int, end: int):
        del self._bits[start:end]

    # -- label-aware codec -------------------------------------------------
    def _codec_segments(self):
        """Ordered, clipped (start, end, coded?) spans covering the whole
        bit-plane; passthrough spans come from apply_decoding=False labels."""
        n = len(self._bits)
        raw_spans = []
        for lbl in self.exclude_from_decoding_labels:
            s, e = max(0, int(lbl.start)), min(n, int(lbl.end))
            if s < e:
                raw_spans.append((s, e))
        raw_spans.sort()

        segments, cursor = [], 0
        for s, e in raw_spans:
            s = max(s, cursor)
            if s >= e:
                continue
            if cursor < s:
                segments.append((cursor, s, True))
            segments.append((s, e, False))
            cursor = e
        if cursor < n or not segments:
            segments.append((cursor, n, True))
        return segments

    def _run_codec(self, decoding: bool):
        """Apply the decoder per segment; returns (Bits, errors, state)."""
        dec = self._decoder
        pieces, errors, states = [], 0, set()
        for s, e, coded in self._codec_segments():
            chunk = self._bits.plane[s:e]
            if coded:
                if decoding:
                    out, err, state = dec.code(True, chunk)
                    errors += err
                    states.add(state)
                else:
                    out = dec.encode(chunk)
                pieces.append(np.asarray(out, dtype=np.uint8))
            else:
                pieces.append(chunk)
        result = Bits(np.concatenate(pieces) if pieces else np.zeros(0, np.uint8))
        states.discard(dec.ErrorState.SUCCESS)
        state = sorted(states)[0] if states else dec.ErrorState.SUCCESS
        return result, errors, state

    @property
    def decoder(self):
        return self._decoder

    @decoder.setter
    def decoder(self, val):
        self._decoder = val
        self._invalidate()
        if val is not None:
            self.decoding_errors, self.decoding_state = val.analyze(self.plain_bits)

    @property
    def decoded_bits(self) -> Bits:
        if self._decoded is None:
            if self._decoder is None:
                self._decoded = self._bits
            else:
                self._decoded, self.decoding_errors, self.decoding_state = \
                    self._run_codec(decoding=True)
        return self._decoded

    @decoded_bits.setter
    def decoded_bits(self, val):
        self._decoded = Bits(val)

    @property
    def encoded_bits(self) -> Bits:
        if self._encoded is None:
            if self._decoder is None:
                self._encoded = self._bits
            else:
                self._encoded = self._run_codec(decoding=False)[0]
        return self._encoded

    def clear_decoded_bits(self):
        self._decoded = None

    def clear_encoded_bits(self):
        self._encoded = None

    # -- string and array views ------------------------------------------
    @property
    def plain_bits_str(self) -> str:
        return str(self)

    @property
    def decoded_bits_str(self) -> str:
        return str(self.decoded_bits)

    @property
    def encoded_bits_str(self) -> str:
        return str(self.encoded_bits)

    @property
    def decoded_bits_buffer(self) -> bytes:
        return self.decoded_bits.tobytes()

    def _alignments(self) -> list:
        if not self.align_labels:
            return []
        bounds = set()
        for lbl in self.message_type:
            bounds.add(lbl.start)
            bounds.add(lbl.end)
        return sorted(bounds)

    def split(self, decode=True):
        """Bit chains split at label boundaries (hex/ASCII alignment)."""
        source = self.decoded_bits if decode else self._bits
        self._bit_alignments = self._alignments()
        cuts = [0, *self._bit_alignments, len(source)]
        return [source[cuts[i]:cuts[i + 1]] for i in range(len(cuts) - 1)]

    def _view_array(self, decode: bool, width: int) -> np.ndarray:
        return _group_reduce(self.split(decode=decode), width)

    @property
    def plain_hex_array(self) -> np.ndarray:
        return self._view_array(False, 4)

    @property
    def plain_hex_str(self) -> str:
        return "".join(_HEX_DIGITS[self.plain_hex_array].tolist())

    @property
    def plain_ascii_array(self) -> np.ndarray:
        return self._view_array(False, 8)

    @property
    def plain_ascii_str(self) -> str:
        return "".join(map(chr, self.plain_ascii_array.tolist()))

    @property
    def decoded_hex_array(self) -> np.ndarray:
        return self._view_array(True, 4)

    @property
    def decoded_hex_str(self) -> str:
        return "".join(_HEX_DIGITS[self.decoded_hex_array].tolist())

    @property
    def decoded_ascii_array(self) -> np.ndarray:
        return self._view_array(True, 8)

    @property
    def decoded_ascii_str(self) -> str:
        return "".join(map(chr, self.decoded_ascii_array.tolist()))

    @property
    def decoded_ascii_buffer(self) -> bytes:
        return self.decoded_ascii_array.tobytes()

    # -- index conversion ---------------------------------------------------
    def _alignment_index(self, view: int, decoded: bool) -> _AlignmentIndex:
        n = len(self.decoded_bits) if decoded else len(self._bits)
        self._bit_alignments = self._alignments()
        return _AlignmentIndex(self._bit_alignments, 4 if view == 1 else 8, n)

    def _char_to_bit_range(self, char_index: int, decoded: bool, is_hex: bool):
        idx = self._alignment_index(1 if is_hex else 2, decoded)
        found = idx.bit_range_of(char_index)
        if found is not None:
            return found
        return idx.factor * char_index, idx.factor * (char_index + 1) - 1

    def convert_index(self, index, from_view: int, to_view: int, decoded: bool):
        """Convert ``index`` between views (0=bit, 1=hex, 2=ASCII).
        Returns an inclusive (start, end) pair like the reference."""
        if to_view == from_view:
            return index, index
        if from_view == 0:
            pos = self._alignment_index(to_view, decoded).char_of(index)
            return pos, pos
        bit_start, bit_end = self._char_to_bit_range(
            index, decoded, is_hex=(from_view == 1))
        if to_view == 0:
            return bit_start, bit_end
        pos = self._alignment_index(to_view, decoded).char_of(bit_start)
        return pos, pos

    def convert_range(self, index1, index2, from_view, to_view, decoded):
        start = self.convert_index(index1, from_view, to_view, decoded)[0]
        end = self.convert_index(index2, from_view, to_view, decoded)[1]
        try:
            return int(start), int(np.ceil(end))
        except TypeError:
            return 0, 0

    def get_byte_length(self, decoded=True) -> int:
        end = len(self.decoded_bits) if decoded else len(self._bits)
        return int(self.convert_index(end, 0, 2, decoded=decoded)[0])

    def get_label_range(self, lbl: ProtocolLabel, view: int, decode: bool,
                        consider_alignment=False):
        offset = self.alignment_offset if consider_alignment else 0
        start = self.convert_index(lbl.start + offset, 0, view, decoded=decode)[0]
        end = self.convert_index(lbl.end + offset, 0, view, decoded=decode)[1]
        return int(start), int(end)

    def get_src_address_from_data(self, decoded=True):
        src_label = next((lbl for lbl in self.message_type
                          if lbl.field_type
                          and lbl.field_type.function == FieldType.Function.SRC_ADDRESS), None)
        if src_label is None:
            return None
        start, end = self.get_label_range(src_label, view=1, decode=decoded)
        return (self.decoded_hex_str if decoded else self.plain_hex_str)[start:end]

    # -- misc ------------------------------------------------------------
    def get_duration(self, sample_rate) -> float:
        if len(self.bit_sample_pos) < 2:
            raise ValueError("not enough bit samples for calculating duration")
        return (self.bit_sample_pos[-1] - self.bit_sample_pos[0]) / sample_rate

    def view_to_string(self, view, decoded, show_pauses=True, sample_rate=None) -> str:
        if view == 0:
            proto = self.decoded_bits_str if decoded else self.plain_bits_str
        elif view == 1:
            proto = self.decoded_hex_str if decoded else self.plain_hex_str
        elif view == 2:
            proto = self.decoded_ascii_str if decoded else self.plain_ascii_str
        else:
            return None
        if show_pauses:
            return "%s %s" % (proto, self.get_pause_str(sample_rate))
        return proto

    def get_pause_str(self, sample_rate):
        if sample_rate:
            return " [<b>Pause:</b> %s s]" % (self.pause / sample_rate)
        return " [<b>Pause:</b> %d samples]" % self.pause

    @property
    def labels(self):
        return self.message_type

    # -- constructors / persistence ---------------------------------------
    @staticmethod
    def from_plain_bits_str(bits: str, pause=0) -> "Message":
        return Message(plain_bits=bits, pause=pause, message_type=MessageType("none"))

    @staticmethod
    def from_plain_hex_str(hex_str: str, pause=0) -> "Message":
        nibbles = np.array([int(h, 16) for h in hex_str], dtype=np.uint8)
        bits = (nibbles[:, None] >> np.arange(3, -1, -1)) & 1
        return Message(plain_bits=bits.reshape(-1), pause=pause,
                       message_type=MessageType("none"))

    def to_xml(self, decoders=None, include_message_type=False, write_bits=False) -> ET.Element:
        root = ET.Element("message")
        root.set("message_type_id", self.message_type.id)
        root.set("modulator_index", str(self.modulator_index))
        root.set("pause", str(self.pause))
        root.set("timestamp", str(self.timestamp))
        if write_bits:
            root.set("bits", self.plain_bits_str)
        if decoders:
            try:
                decoding_index = decoders.index(self.decoder)
            except ValueError:
                decoding_index = 0
            root.set("decoding_index", str(decoding_index))
        if self.participant is not None:
            root.set("participant_id", self.participant.id)
        if include_message_type:
            root.append(self.message_type.to_xml())
        return root

    def from_xml(self, tag: ET.Element, participants, decoders=None, message_types=None):
        timestamp = tag.get("timestamp", None)
        if timestamp:
            self.timestamp = float(timestamp)
        self.modulator_index = int(tag.get("modulator_index", self.modulator_index))
        self.pause = int(tag.get("pause", self.pause))

        decoding_index = tag.get("decoding_index", None)
        if decoding_index and decoders is not None:
            try:
                self.decoder = decoders[int(decoding_index)]
            except IndexError:
                pass
        part_id = tag.get("participant_id", None)
        if part_id:
            self.participant = Participant.find_matching(part_id, participants)
        message_type_id = tag.get("message_type_id", None)
        if message_type_id and message_types:
            self.message_type = next(
                (mt for mt in message_types if mt.id == message_type_id),
                self.message_type)
        message_type_tag = tag.find("message_type")
        if message_type_tag is not None:
            self.message_type = MessageType.from_xml(message_type_tag)

    @classmethod
    def new_from_xml(cls, tag: ET.Element, participants, decoders=None, message_types=None):
        assert "bits" in tag.attrib
        result = cls.from_plain_bits_str(bits=tag.get("bits"))
        result.from_xml(tag, participants, decoders=decoders, message_types=message_types)
        return result
