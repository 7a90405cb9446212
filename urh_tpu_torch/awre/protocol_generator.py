"""Labeled protocol synthesis for awre testing.

Behavioral contract: urh/awre/ProtocolGenerator.py (minus its LaTeX
export).  Restructured as a segment-emitter table: each field function
maps to one emitter producing its bit segment; the message is the
concatenation of inter-label zero gaps and emitted segments, with
checksum fields patched in after assembly.
"""

from __future__ import annotations

import math
import struct
from collections import defaultdict

from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer
from urh_tpu_torch.protocol.labels import ChecksumLabel, FieldType, MessageType, Participant
from urh_tpu_torch.protocol.message import Message

_F = FieldType.Function
_HEX_TO_BITS = {"{0:x}".format(v): "{0:04b}".format(v) for v in range(16)}
_STRUCT_BY_WIDTH = {8: "B", 16: "H", 32: "I", 64: "Q"}


class ProtocolGenerator:
    DEFAULT_PREAMBLE = "10101010"
    DEFAULT_SYNC = "1001"
    BROADCAST_ADDRESS = "0xffff"

    def __init__(self, message_types: list, participants: list = None,
                 preambles_by_mt=None, syncs_by_mt=None, little_endian=False,
                 length_in_bytes=True, sequence_numbers=None,
                 sequence_number_increment=1, message_type_codes=None):
        self.participants = [] if participants is None else participants

        self.protocol = ProtocolAnalyzer(None)
        self.protocol.message_types = message_types

        self.length_in_bytes = length_in_bytes
        self.little_endian = little_endian

        self.preambles_by_message_type = self._bit_table(
            preambles_by_mt, self.DEFAULT_PREAMBLE)
        self.syncs_by_message_type = self._bit_table(syncs_by_mt, self.DEFAULT_SYNC)

        self.sequence_numbers = defaultdict(int)
        self.sequence_numbers.update(sequence_numbers or {})
        self.sequence_number_increment = sequence_number_increment

        if message_type_codes is None:
            message_type_codes = {mt: i for i, mt in enumerate(self.message_types)}
        self.message_type_codes = message_type_codes

    @classmethod
    def _bit_table(cls, by_message_type, default: str):
        table = defaultdict(lambda: default)
        for mt, pattern in (by_message_type or {}).items():
            table[mt] = cls.to_bits(pattern)
        return table

    @property
    def messages(self):
        return self.protocol.messages

    @property
    def message_types(self):
        return self.protocol.message_types

    @staticmethod
    def to_bits(bit_or_hex_str: str):
        if bit_or_hex_str.startswith("0x"):
            return "".join(_HEX_TO_BITS[c] for c in bit_or_hex_str[2:])
        return bit_or_hex_str

    def _address_bits(self, participant: Participant):
        if participant is None:
            return self.to_bits(self.BROADCAST_ADDRESS)
        raw = participant.address_hex
        return self.to_bits(raw if raw.startswith("0x") else "0x" + raw)

    def decimal_to_bits(self, number: int, num_bits: int) -> str:
        if num_bits not in _STRUCT_BY_WIDTH:
            raise ValueError(f"invalid length for length field: {num_bits} bits")
        spec = ("<" if self.little_endian else ">") + _STRUCT_BY_WIDTH[num_bits]
        return "".join("{0:08b}".format(byte) for byte in struct.pack(spec, number))

    def generate_message(self, message_type=None, data="0x00",
                         source: Participant = None, destination: Participant = None):
        for endpoint in (source, destination):
            if isinstance(endpoint, Participant) and endpoint not in self.participants:
                self.participants.append(endpoint)

        mt = self._resolve_message_type(message_type)
        mt.sort()
        data = self.to_bits(data)

        has_data_label = mt.get_first_label_with_type(_F.DATA) is not None
        # payload length the LENGTH field reports (preamble/sync excluded)
        reported = mt[-1].end - 1 + (0 if has_data_label else len(data))
        framing = (len(self.preambles_by_message_type[mt])
                   if mt.get_first_label_with_type(_F.PREAMBLE) else 0)
        framing += (len(self.syncs_by_message_type[mt])
                    if mt.get_first_label_with_type(_F.SYNC) else 0)
        reported -= framing

        def length_value(width):
            value = int(math.ceil(reported / 8))
            return value if self.length_in_bytes else value * 8

        emitters = {
            _F.PREAMBLE: lambda width: self.preambles_by_message_type[mt],
            _F.SYNC: lambda width: self.syncs_by_message_type[mt],
            _F.LENGTH: lambda width: self.decimal_to_bits(length_value(width), width),
            _F.TYPE: lambda width: self.decimal_to_bits(
                self.message_type_codes[mt] % (1 << width), width),
            _F.SEQUENCE_NUMBER: lambda width: self.decimal_to_bits(
                self.sequence_numbers[mt] % (1 << width), width),
            _F.DST_ADDRESS: lambda width: self._sized(
                self._address_bits(destination), width, "dst"),
            _F.SRC_ADDRESS: lambda width: self._sized(
                self._address_bits(source), width, "src"),
            _F.DATA: lambda width: self._sized(data, width, "data"),
        }

        segments = []
        cursor = 0
        deferred_checksums = []
        for lbl in mt:
            segments.append("0" * (lbl.start - cursor))
            if isinstance(lbl, ChecksumLabel):
                # left unwritten: the following label's gap supplies the
                # zeros; the real value is patched in post-assembly
                deferred_checksums.append(lbl)
                continue
            emit = emitters.get(lbl.field_type.function)
            if emit is not None:
                segments.append(emit(lbl.end - lbl.start))
            cursor = lbl.end
        if not has_data_label:
            segments.append(data)

        msg = Message.from_plain_bits_str("".join(segments))
        msg.message_type = mt
        msg.participant = source
        self.sequence_numbers[mt] += self.sequence_number_increment

        for lbl in deferred_checksums:
            msg[lbl.start : lbl.end] = lbl.calculate_checksum_for_message(msg, False)

        self.protocol.messages.append(msg)

    def _resolve_message_type(self, message_type) -> MessageType:
        if isinstance(message_type, MessageType):
            return self.protocol.message_types[
                self.protocol.message_types.index(message_type)]
        if isinstance(message_type, int):
            return self.protocol.message_types[message_type]
        return self.protocol.message_types[0]

    @staticmethod
    def _sized(bits: str, width: int, what: str) -> str:
        if len(bits) != width:
            raise ValueError(
                f"length of {what} ({len(bits)} bits) != field ({width} bits)")
        return bits

    def to_file(self, filename: str):
        self.protocol.to_xml_file(filename, [], self.participants, write_bits=True)
