"""Parametric CRC engine and CRC reverse engineering.

Counterpart of urh/util/GenericCRC.py (616 LoC) plus the bitwise kernels
from urh/cythonext/util.pyx:75-304.  The kernels here use Python/numpy
integer arithmetic (messages are short, and Python ints are arbitrary
precision, covering poly orders > 64).  Host copy of urh_tpu.coding.crc;
for sweeping one CRC config over many equal-length messages at once there
is a batched GF(2)-matmul variant on the device:
urh_tpu_torch.awre.device.batched_crc.

Supports arbitrary polynomials, start value, final xor, lsb-first input,
reversed polynomial, reversed output and little-endian byte order, plus:

* ``get_crc_datarange`` — find which data range a received CRC covers by
  incremental one-bit delta steps (util.pyx:216-304);
* ``guess_all`` / ``bruteforce_all`` — standard-config and exhaustive
  parameter search;
* ``reverse_engineer_polynomial`` — from pairs of one-bit-different
  messages.
"""

from __future__ import annotations

import array
import copy
import functools
import itertools
from collections import OrderedDict
from xml.etree import ElementTree as ET


def bits_to_int(bits, reverse=False, start=0) -> int:
    """arr_to_number semantics (util.pyx:63-73): LSB-last unless reversed."""
    result = 0
    n = len(bits)
    for i in range(start, n):
        if not reverse:
            if bits[n - 1 - i + start]:
                result |= 1 << (i - start)
        else:
            if bits[i]:
                result |= 1 << (i - start)
    return result


def int_to_bits(n: int, length: int) -> array.array:
    return array.array("B", ((n >> (length - 1 - i)) & 1 for i in range(length)))


@functools.lru_cache(maxsize=1 << 16)
def _reflect(value: int, width: int) -> int:
    out = 0
    for i in range(width):
        if value & (1 << i):
            out |= 1 << (width - 1 - i)
    return out


def _little_endian_swap(value: int, width: int) -> int:
    if width == 16:
        return ((value << 8) & 0xFF00) | (value >> 8)
    if width == 32:
        return (
            ((value << 24) & 0xFF000000)
            | ((value << 8) & 0x00FF0000)
            | ((value >> 8) & 0x0000FF00)
            | (value >> 24)
        )
    if width == 64:
        v = value
        return (
            ((v << 56) & 0xFF00000000000000) | (v >> 56)
            | ((v >> 40) & 0x000000000000FF00) | ((v << 40) & 0x00FF000000000000)
            | ((v << 24) & 0x0000FF0000000000) | ((v >> 24) & 0x0000000000FF0000)
            | ((v << 8) & 0x000000FF00000000) | ((v >> 8) & 0x00000000FF000000)
        )
    return value


def bit_column_order(n: int, lsb_first: bool) -> list:
    """Bit-index processing order of the CRC engine: plain for MSB-first;
    LSB-first walks each byte high-to-low, and a trailing partial byte is
    skipped entirely (its first in-byte probe already exceeds n — the
    reference engine's byte-loop break, util.pyx:86-95).  Shared by the
    scalar engine here and the batched sweeps in awre/crc_search.py."""
    if not lsb_first:
        return list(range(n))
    order = []
    for base in range(0, n - 7, 8):
        order.extend(range(base + 7, base - 1, -1))
    return order


def crc_int(inpt, polynomial, start_value, final_xor, lsb_first, reverse_polynomial,
            reverse_all, little_endian) -> int:
    """Generic bitwise CRC (util.pyx:75-125 semantics) returning an int."""
    width = len(polynomial) - 1
    crc_mask = (1 << width) - 1
    poly_mask = (crc_mask + 1) >> 1
    poly_int = bits_to_int(polynomial, reverse_polynomial, 1) & crc_mask

    crc = bits_to_int(start_value) & crc_mask
    for idx in bit_column_order(len(inpt), lsb_first):
        feed = ((crc & poly_mask) > 0) != bool(inpt[idx])
        crc = ((crc << 1) & crc_mask) ^ (poly_int if feed else 0)

    crc ^= bits_to_int(final_xor) & crc_mask
    if reverse_all:
        crc = _reflect(crc, width) & crc_mask
    if little_endian:
        crc = _little_endian_swap(crc, width)
    return crc & crc_mask


def get_crc_datarange(inpt, polynomial, vrfy_crc_start, start_value, final_xor,
                      lsb_first, reverse_polynomial, reverse_all, little_endian):
    """Find (data_begin, data_end) such that crc(inpt[begin:end]) equals the
    CRC stored at ``vrfy_crc_start`` (util.pyx:216-304).

    Uses the linearity of CRC: precompute the CRC deltas of single leading
    one-bits, then peel data bits from the front one at a time.
    """
    len_inpt = len(inpt)
    poly_order = len(polynomial)
    width = poly_order - 1
    if vrfy_crc_start - 1 + width >= len_inpt or vrfy_crc_start < 2:
        return 0, 0

    crc_mask = (1 << width) - 1
    poly_mask = (crc_mask + 1) >> 1
    poly_int = bits_to_int(polynomial, reverse_polynomial, 1) & crc_mask
    final_xor_int = bits_to_int(final_xor) & crc_mask
    vrfy_crc_int = bits_to_int(inpt[vrfy_crc_start : vrfy_crc_start + width]) & crc_mask
    data_end = vrfy_crc_start

    # steps[idx] = crc of the bit string 1 followed by (data_end-1-idx) zeros:
    # the engine run over an impulse input (only column 0 set)
    steps = [0] * (len_inpt + 2)
    crcv = bits_to_int(start_value) & crc_mask
    for idx in bit_column_order(data_end, lsb_first):
        feed = ((crcv & poly_mask) > 0) != (idx == 0)
        crcv = ((crcv << 1) & crc_mask) ^ (poly_int if feed else 0)
        steps[idx] = crcv ^ final_xor_int

    if reverse_all and little_endian:
        # faithful to the reference's interleaving (util.pyx:264-270):
        # the reflect of iteration i can read the slot overwritten at i-1
        for i in range(data_end):
            # NOTE: the reference writes the reflected value to steps[j]
            # instead of steps[i] (util.pyx:267) — an upstream bug kept
            # for behavioral parity of the search results.
            temp = _reflect(steps[i], width)
            j = width  # loop variable value after the reference's loop
            steps[j] = temp & crc_mask
            steps[i] = _little_endian_swap(steps[i], width)
    elif reverse_all:
        # every iteration of the reference loop overwrites the same
        # steps[width] slot (the bug above), so only the last write lands;
        # when data_end-1 == width the final read sees the previous write
        if data_end > 0:
            last = steps[data_end - 1]
            if data_end - 1 == width and data_end > 1:
                last = _reflect(steps[data_end - 2], width) & crc_mask
            steps[width] = _reflect(last, width) & crc_mask
    elif little_endian:
        steps[:data_end] = [_little_endian_swap(s, width)
                            for s in steps[:data_end]]

    crcvalue = crc_int(inpt[:data_end], polynomial, start_value, final_xor,
                       lsb_first, reverse_polynomial, reverse_all, little_endian)
    if vrfy_crc_int == crcvalue:
        return 0, data_end
    found = False
    i = 0
    while i < data_end - 1:
        offset = 0
        # skip leading zeros in data (they do not change the crc)
        while not inpt[i + offset] and i + offset < data_end - 1:
            offset += 1
        crcvalue ^= steps[data_end - i - offset - 1]
        if found:
            return i, data_end
        if vrfy_crc_int == crcvalue:
            found = True
        i += 1 + offset
    return 0, 0


class GenericCRC:
    # https://en.wikipedia.org/wiki/Polynomial_representations_of_cyclic_redundancy_checks
    # stored as bit strings (leading term included), expanded to bit
    # arrays below; same polynomials as the reference's tables
    DEFAULT_POLYNOMIALS = OrderedDict(
        (name, array.array("B", [c == "1" for c in bits]))
        for name, bits in (
            # x^8 + x^7 + x^6 + x^4 + x^2 + 1
            ("8_standard", "111010101"),
            # x^16 + x^15 + x^2 + x^0
            ("16_standard", "11000000000000101"),
            # x^16 + x^12 + x^5 + x^0
            ("16_ccitt", "10001000000100001"),
            # x^16 + x^13 + x^12 + x^11 + x^10 + x^8 + x^6 + x^5 + x^2 + x^0
            ("16_dnp", "10011110101100101"),
            # x^8 + x^2 + x + 1
            ("8_ccitt", "100000111"),
        )
    )

    # (name, poly hex, start, xor, ref_in, ref_out) rows; expanded into
    # the parameter-dict form the search APIs consume
    _STANDARD_ROWS = (
        ("CRC8 (default)", "0xD5", 0, 0, False, False),
        ("CRC8 CCITT", "0x07", 0, 0, False, False),
        ("CRC8 Bluetooth", "0xA7", 0, 0, True, True),
        ("CRC8 DARC", "0x39", 0, 0, True, True),
        ("CRC8 NRSC-5", "0x31", 1, 0, False, False),
        ("CRC16 (default)", "0x8005", 0, 0, True, True),
        ("CRC16 CCITT", "0x1021", 0, 0, True, True),
        ("CRC16 NRSC-5", "0x080B", 1, 0, True, True),
        ("CRC16 CC1101", "0x8005", 1, 0, False, False),
        ("CRC16 CDMA2000", "0xC867", 1, 0, False, False),
        ("CRC32 (default)", "0x04C11DB7", 1, 1, True, True),
    )

    STANDARD_CHECKSUMS = OrderedDict(
        (name, dict(polynomial=poly, start_value=start, final_xor=xor,
                    ref_in=ref_in, ref_out=ref_out))
        for name, poly, start, xor, ref_in, ref_out in _STANDARD_ROWS
    )

    def __init__(self, polynomial="16_standard", start_value=False, final_xor=False,
                 reverse_polynomial=False, reverse_all=False, little_endian=False,
                 lsb_first=False):
        self.caption = polynomial if isinstance(polynomial, str) else ""
        self.polynomial = self.choose_polynomial(polynomial)
        self.reverse_polynomial = reverse_polynomial
        self.reverse_all = reverse_all
        self.little_endian = little_endian
        self.lsb_first = lsb_first

        self.start_value = self._read_parameter(start_value)
        self.final_xor = self._read_parameter(final_xor)

    def _read_parameter(self, value):
        if isinstance(value, (bool, int)):
            return array.array("B", [value] * (self.poly_order - 1))
        if len(value) == self.poly_order - 1:
            return value
        return array.array("B", value[0] * (self.poly_order - 1))

    def __eq__(self, other):
        if not isinstance(other, GenericCRC):
            return False
        return all(
            getattr(self, a) == getattr(other, a)
            for a in ("polynomial", "reverse_polynomial", "reverse_all",
                      "little_endian", "lsb_first", "start_value", "final_xor")
        )

    def __hash__(self):
        return hash((self.polynomial.tobytes(), self.reverse_polynomial, self.reverse_all,
                     self.little_endian, self.lsb_first, self.start_value.tobytes(),
                     self.final_xor.tobytes()))

    @property
    def poly_order(self):
        return len(self.polynomial)

    @property
    def polynomial_as_bit_str(self) -> str:
        return "".join("1" if p else "0" for p in self.polynomial)

    @property
    def polynomial_as_hex_str(self) -> str:
        bits = self.polynomial[1:]  # no leading one
        out = ""
        b = list(bits)
        while len(b) % 4:
            b.append(0)
        for i in range(0, len(b), 4):
            out += "{0:x}".format(int("".join(map(str, b[i : i + 4])), 2))
        return out

    def set_polynomial_from_hex(self, hex_str: str):
        from urh_tpu_torch.coding.encodings import hex2bit

        self.polynomial = array.array("B", [1]) + hex2bit(hex_str)

    def choose_polynomial(self, polynomial):
        if isinstance(polynomial, str):
            return self.DEFAULT_POLYNOMIALS[polynomial]
        if isinstance(polynomial, int):
            return list(self.DEFAULT_POLYNOMIALS.items())[polynomial][1]
        return polynomial

    def get_parameters(self):
        return (self.polynomial, self.start_value, self.final_xor, self.lsb_first,
                self.reverse_polynomial, self.reverse_all, self.little_endian)

    def crc(self, inpt) -> array.array:
        result = crc_int(inpt, self.polynomial, self.start_value, self.final_xor,
                         self.lsb_first, self.reverse_polynomial, self.reverse_all,
                         self.little_endian)
        return int_to_bits(result, self.poly_order - 1)

    # integer-kernel path is already table-free and fast; the cached/table
    # API is kept for parity (GenericCRC.py:201-228)
    def cached_crc(self, inpt, bits=8) -> array.array:
        if not getattr(self, "cache", None):
            self.calculate_cache(bits)
        return self.crc(inpt)

    def calculate_cache(self, bits=8):
        """Table of the engine advanced ``bits`` steps from each of the
        2^bits zero-fed start states (GenericCRC.py:218-228)."""
        width = self.poly_order - 1
        cache_bits = bits if 0 < bits < self.poly_order else min(8, width)
        crc_mask = (1 << width) - 1
        poly_mask = (crc_mask + 1) >> 1
        poly_int = bits_to_int(self.polynomial, self.reverse_polynomial, 1) & crc_mask

        def advance(state):
            for _ in range(cache_bits):
                feed = bool(state & poly_mask)
                state = ((state << 1) & crc_mask) ^ (poly_int if feed else 0)
            return state

        self.cache = [advance(i << (width - cache_bits))
                      for i in range(1 << cache_bits)]

    def calculate(self, bits):
        return self.crc(bits)

    def reference_crc(self, inpt) -> array.array:
        """Independent bit-list CRC implementation used by tests to
        cross-validate the integer kernel (GenericCRC.py:242-293)."""
        len_inpt = len(inpt)
        if len(self.start_value) < self.poly_order - 1:
            return False
        crc = copy.copy(array.array("B", self.start_value[0 : self.poly_order - 1]))

        for i in range(0, len_inpt + 7, 8):
            for j in range(8):
                idx = i + (7 - j) if self.lsb_first else i + j
                if idx >= len_inpt:
                    break
                do_xor = crc[0] != inpt[idx]
                crc[0 : self.poly_order - 2] = crc[1 : self.poly_order - 1]
                crc[self.poly_order - 2] = False
                if do_xor:
                    for x in range(self.poly_order - 1):
                        if self.reverse_polynomial:
                            crc[x] ^= self.polynomial[self.poly_order - 1 - x]
                        else:
                            crc[x] ^= self.polynomial[x + 1]

        for i in range(self.poly_order - 1):
            if self.final_xor[i]:
                crc[i] = not crc[i]

        if self.reverse_all:
            crc = array.array("B", [crc[self.poly_order - 2 - i] for i in range(self.poly_order - 1)])

        def swap_bytes(arr, pos1, pos2):
            arr[pos1 * 8 : pos1 * 8 + 8], arr[pos2 * 8 : pos2 * 8 + 8] = (
                arr[pos2 * 8 : pos2 * 8 + 8], arr[pos1 * 8 : pos1 * 8 + 8],
            )

        if self.poly_order - 1 == 16 and self.little_endian:
            swap_bytes(crc, 0, 1)
        elif self.poly_order - 1 == 32 and self.little_endian:
            swap_bytes(crc, 0, 3)
            swap_bytes(crc, 1, 2)
        elif self.poly_order - 1 == 64 and self.little_endian:
            for pos1, pos2 in [(0, 7), (1, 6), (2, 5), (3, 4)]:
                swap_bytes(crc, pos1, pos2)
        return array.array("B", crc)

    def get_crc_datarange(self, inpt, vrfy_crc_start):
        return get_crc_datarange(inpt, self.polynomial, vrfy_crc_start,
                                 self.start_value, self.final_xor, self.lsb_first,
                                 self.reverse_polynomial, self.reverse_all,
                                 self.little_endian)

    # -- parameter search ------------------------------------------------
    @staticmethod
    def from_standard_checksum(name: str):
        result = GenericCRC()
        result.set_individual_parameters(**GenericCRC.STANDARD_CHECKSUMS[name])
        result.caption = name
        return result

    def set_individual_parameters(self, polynomial, start_value=0, final_xor=0,
                                  ref_in=False, ref_out=False, little_endian=False,
                                  reverse_polynomial=False):
        if isinstance(polynomial, str):
            self.set_polynomial_from_hex(polynomial)
        else:
            self.polynomial = polynomial

        if isinstance(start_value, int):
            self.start_value = array.array("B", [start_value] * (self.poly_order - 1))
        elif isinstance(start_value, array.array) and len(start_value) == self.poly_order - 1:
            self.start_value = start_value
        else:
            raise ValueError("invalid start value length")

        if isinstance(final_xor, int):
            self.final_xor = array.array("B", [final_xor] * (self.poly_order - 1))
        elif isinstance(final_xor, array.array) and len(final_xor) == self.poly_order - 1:
            self.final_xor = final_xor
        else:
            raise ValueError("invalid final xor length")

        self.reverse_polynomial = reverse_polynomial
        self.reverse_all = ref_out
        self.little_endian = little_endian
        self.lsb_first = ref_in

    def set_crc_parameters(self, i):
        """8-bit parameter-space encoding for bruteforce search
        (GenericCRC.py:365-413)."""
        self.polynomial = self.choose_polynomial((i >> 0) & 3)
        poly_order = len(self.polynomial)
        self.start_value = array.array("B", [(i >> 2) & 1] * (poly_order - 1))
        self.final_xor = array.array("B", [(i >> 3) & 1] * (poly_order - 1))
        self.reverse_polynomial = bool((i >> 4) & 1)
        self.reverse_all = bool((i >> 5) & 1)
        self.little_endian = bool((i >> 6) & 1)
        self.lsb_first = bool((i >> 7) & 1)

    @classmethod
    def _initialize_standard_checksums(cls):
        from urh_tpu_torch.coding.encodings import hex2bit

        for name in cls.STANDARD_CHECKSUMS:
            polynomial = cls.STANDARD_CHECKSUMS[name]["polynomial"]
            if isinstance(polynomial, str):
                polynomial = array.array("B", [1]) + hex2bit(polynomial)
                cls.STANDARD_CHECKSUMS[name]["polynomial"] = polynomial
            n = len(polynomial) - 1
            start_val = cls.STANDARD_CHECKSUMS[name].get("start_value", 0)
            if isinstance(start_val, int):
                cls.STANDARD_CHECKSUMS[name]["start_value"] = array.array("B", [start_val] * n)
            final_xor = cls.STANDARD_CHECKSUMS[name].get("final_xor", 0)
            if isinstance(final_xor, int):
                cls.STANDARD_CHECKSUMS[name]["final_xor"] = array.array("B", [final_xor] * n)

    def guess_all(self, bits, trash_max=7, ignore_positions: set = None):
        """-> (crc_object, data_start, data_end, crc_start, crc_end) or zeros."""
        self._initialize_standard_checksums()
        ignore_positions = set() if ignore_positions is None else ignore_positions
        for i in range(0, trash_max):
            ret = self.guess_standard_parameters_and_datarange(bits, i)
            if ret == (0, 0, 0):
                continue
            crc_start, crc_end = len(bits) - i - ret[0].poly_order + 1, len(bits) - i
            if not any(p in ignore_positions for p in range(crc_start, crc_end)):
                return ret[0], ret[1], ret[2], crc_start, crc_end
        return 0, 0, 0, 0, 0

    def bruteforce_all(self, inpt, trash_max=7):
        polynomial_sizes = [16, 8]
        len_input = len(inpt)
        for s in polynomial_sizes:
            for i in range(len_input - s - trash_max, len_input - s):
                ret = self.bruteforce_parameters_and_data_range(inpt, i)
                if ret != (0, 0, 0):
                    return ret[0], ret[1], ret[2], i, i + s
        return 0, 0, 0, 0, 0

    def guess_standard_parameters(self, inpt, vrfy_crc):
        for i in range(0, 2 ** 8):
            self.set_crc_parameters(i)
            if len(vrfy_crc) == self.poly_order and self.crc(inpt) == vrfy_crc:
                return i
        return False

    def guess_standard_parameters_and_datarange(self, inpt, trash):
        # longer polynomials first: less risk of false positives
        for name, parameters in sorted(
            self.STANDARD_CHECKSUMS.items(),
            key=lambda x: len(x[1]["polynomial"]),
            reverse=True,
        ):
            self.caption = name
            data_begin, data_end = get_crc_datarange(
                inpt,
                parameters["polynomial"],
                max(0, len(inpt) - trash - len(parameters["polynomial"])) + 1,
                parameters["start_value"],
                parameters["final_xor"],
                parameters.get("ref_in", False),
                parameters.get("reverse_polynomial", False),
                parameters.get("ref_out", False),
                parameters.get("little_endian", False),
            )
            if (data_begin, data_end) != (0, 0):
                self.set_individual_parameters(**parameters)
                return self, data_begin, data_end
        return 0, 0, 0

    def bruteforce_parameters_and_data_range(self, inpt, vrfy_crc_start):
        for i in range(0, 2 ** 8):
            self.set_crc_parameters(i)
            data_begin, data_end = self.get_crc_datarange(inpt, vrfy_crc_start)
            if (data_begin, data_end) != (0, 0):
                return i, data_begin, data_end
        return 0, 0, 0

    def reverse_engineer_polynomial(self, dataset, crcset):
        """Recover the polynomial from message pairs differing in one bit
        (GenericCRC.py:524-567 semantics, pairwise diffs via numpy)."""
        import numpy as np

        if len(dataset) != len(crcset) or len(dataset) < 3:
            return False

        # collect (flip position -> crc delta) from every one-bit pair
        data = [np.asarray(d, dtype=np.uint8) for d in dataset]
        crcs = [np.asarray(c, dtype=np.uint8) for c in crcset]
        delta_by_pos = []
        for i, j in itertools.combinations(range(len(data)), 2):
            if data[i].shape != data[j].shape or crcs[i].shape != crcs[j].shape:
                continue
            diff = np.flatnonzero(data[i] != data[j])
            if len(diff) == 1:
                delta_by_pos.append((int(diff[0]), crcs[i] ^ crcs[j]))

        # adjacent flip positions relate by one shift of the polynomial
        for pos_a, delta_a in delta_by_pos:
            for pos_b, delta_b in delta_by_pos:
                if pos_a + 1 == pos_b and delta_b[0]:
                    polynomial = delta_a.copy()
                    polynomial[:-1] ^= delta_b[1:]
                    return polynomial.tolist()
        return False

    # -- persistence -----------------------------------------------------
    def to_xml(self) -> ET.Element:
        root = ET.Element("crc")
        root.set("polynomial", "".join(map(str, self.polynomial)))
        root.set("start_value", "".join(map(str, self.start_value)))
        root.set("final_xor", "".join(map(str, self.final_xor)))
        root.set("ref_in", str(int(self.lsb_first)))
        root.set("ref_out", str(int(self.reverse_all)))
        return root

    @classmethod
    def from_xml(cls, tag: ET.Element):
        polynomial = tag.get("polynomial", "1010")
        start_value = tag.get("start_value", "0000")
        final_xor = tag.get("final_xor", "0000")
        ref_in = bool(int(tag.get("ref_in", "0")))
        ref_out = bool(int(tag.get("ref_out", "0")))
        to_arr = lambda s: array.array("B", [c == "1" for c in s])
        return GenericCRC(polynomial=to_arr(polynomial), start_value=to_arr(start_value),
                          final_xor=to_arr(final_xor), lsb_first=ref_in, reverse_all=ref_out)

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def bit2str(inpt):
        return "".join("1" if x else "0" for x in inpt)

    @staticmethod
    def str2bit(inpt):
        return [x == "1" for x in inpt]

    @staticmethod
    def str2arr(inpt):
        return array.array("B", GenericCRC.str2bit(inpt))

    @staticmethod
    def bit2int(inpt):
        return int(GenericCRC.bit2str(inpt), 2)

    @staticmethod
    def hex2str(inpt):
        bitstring = bin(int(inpt, base=16))[2:]
        return "0" * (4 * len(inpt.lstrip("0x")) - len(bitstring)) + bitstring
