"""EnOcean Wireless Short Packet (WSP) checksums.

Counterpart of urh/util/WSPChecksum.py: the three hashes of the WSP
standard (hes-standards.org SC25_WG1_N1493) — 4-bit checksum for switch
telegrams, 8-bit additive checksum, and CRC-8 — plus auto selection by
RORG/STATUS and a search helper for the checksum engine.
"""

from __future__ import annotations

import array
import copy
from enum import Enum

import numpy as np
from xml.etree import ElementTree as ET

from urh_tpu_torch.coding.crc import GenericCRC
from urh_tpu_torch.coding.encodings import hex2bit


class WSPChecksum:
    class ChecksumMode(Enum):
        auto = 0
        checksum4 = 1
        checksum8 = 2
        crc8 = 3

    CRC_8_POLYNOMIAL = array.array("B", [1, 0, 0, 0, 0, 0, 1, 1, 1])  # x^8+x^2+x+1

    def __init__(self, mode=ChecksumMode.auto):
        self.mode = mode
        self.caption = str(mode)

    def __eq__(self, other):
        return isinstance(other, WSPChecksum) and self.mode == other.mode

    def __hash__(self):
        return hash(self.mode)

    def _auto_select(self, msg: array.array):
        """Pick the hash by RORG and STATUS as the standard prescribes."""
        if msg[0:4] in (hex2bit("5"), hex2bit("6")):
            return self.checksum4(msg)  # switch telegram
        status = msg[-16:-8]
        # STATUS bit 2^7 set -> telegram carries a CRC8, else additive sum
        return self.crc8(msg[:-8]) if status[0] else self.checksum8(msg[:])

    def calculate(self, msg: array.array):
        """Checksum of a WSP message (without preamble/SOF/EOF; starts at
        RORG, ends with the stored hash)."""
        Mode = self.ChecksumMode
        try:
            return {
                Mode.auto: lambda: self._auto_select(msg),
                Mode.checksum4: lambda: self.checksum4(msg),
                Mode.checksum8: lambda: self.checksum8(msg[:]),
                Mode.crc8: lambda: self.crc8(msg[:-8]),
            }[self.mode]()
        except IndexError:
            return None

    @classmethod
    def search_for_wsp_checksum(cls, bits_behind_sync):
        if bits_behind_sync[-4:].tobytes() != array.array("B", [1, 0, 1, 1]).tobytes():
            return 0, 0, 0, 0  # no EOF

        rorg = bits_behind_sync[0:4].tobytes()
        if rorg in (array.array("B", [0, 1, 0, 1]).tobytes(), array.array("B", [0, 1, 1, 0]).tobytes()):
            # switch telegram
            if cls.checksum4(bits_behind_sync[-8:]).tobytes() == bits_behind_sync[-8:-4].tobytes():
                crc_start = len(bits_behind_sync) - 8
                crc_stop = len(bits_behind_sync) - 4
                return 0, crc_start, crc_start, crc_stop
        return 0, 0, 0, 0

    @staticmethod
    def _byte_sum(bits, stop):
        """Sum of the 8-bit groups in bits[:stop] (one packbits pass);
        a trailing partial group reads as its right-aligned value."""
        arr = np.asarray(bits[:stop], dtype=np.uint8)
        full = (arr.size // 8) * 8
        total = int(np.packbits(arr[:full]).astype(np.int64).sum())
        tail = arr[full:]
        if tail.size:
            total += int(np.packbits(tail)[0]) >> (8 - tail.size)
        return total

    @staticmethod
    def _to_bits(value: int, width: int) -> array.array:
        word = np.unpackbits(np.uint8(value & 0xFF))[-width:]
        return array.array("B", word.tolist())

    @classmethod
    def checksum4(cls, bits: array.array) -> array.array:
        val = copy.copy(bits)
        val[-4:] = array.array("B", [False] * 4)
        acc = cls._byte_sum(val, len(val))
        acc = (((acc & 0xF0) >> 4) + (acc & 0x0F)) & 0x0F
        return cls._to_bits(acc, 4)

    @classmethod
    def checksum8(cls, bits: array.array) -> array.array:
        acc = cls._byte_sum(bits, len(bits) - 8)
        return cls._to_bits(acc % 256, 8)

    @classmethod
    def crc8(cls, bits: array.array) -> array.array:
        return array.array("B", GenericCRC(polynomial=cls.CRC_8_POLYNOMIAL).crc(bits))

    def to_xml(self) -> ET.Element:
        root = ET.Element("wsp_checksum")
        root.set("mode", str(self.mode.name))
        return root

    @classmethod
    def from_xml(cls, tag: ET.Element):
        return WSPChecksum(mode=WSPChecksum.ChecksumMode[tag.get("mode", "auto")])
