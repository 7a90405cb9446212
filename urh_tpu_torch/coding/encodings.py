"""Invertible bit-level decodings.

Counterpart of urh/signalprocessing/Encoding.py (973 LoC): a decoding is
a chain of invertible primitives applied in order when decoding and in
reverse order when encoding.  Primitives: invert, differential,
redundancy removal, carrier removal, CC1101 data whitening (LFSR x^5+1
keystream after sync-word search), LSB-first byte order, edge trigger,
substitution tables, external programs, cut, morse, and the EnOcean
Wireless Short Packet line code.

Primitives are host bit-ops (messages are short and ragged; the device
wins nothing here).
"""

from __future__ import annotations

import array

import numpy as np
from xml.etree import ElementTree as ET

# Chain-name constants (settings.py:89-101 in the reference)
DECODING_NAMES = {
    "invert": "Invert",
    "differential": "Differential Encoding",
    "redundancy": "Remove Redundancy",
    "data_whitening": "Remove Data Whitening (CC1101)",
    "carrier": "Remove Carrier",
    "bitorder": "Change Bitorder",
    "edge": "Edge Trigger",
    "substitution": "Substitution",
    "external": "External Program",
    "enocean": "Wireless Short Packet (WSP)",
    "cut": "Cut before/after",
    "morse": "Morse Code",
}

DECODING_INVERT = DECODING_NAMES["invert"]
DECODING_DIFFERENTIAL = DECODING_NAMES["differential"]
DECODING_REDUNDANCY = DECODING_NAMES["redundancy"]
DECODING_DATAWHITENING = DECODING_NAMES["data_whitening"]
DECODING_CARRIER = DECODING_NAMES["carrier"]
DECODING_BITORDER = DECODING_NAMES["bitorder"]
DECODING_EDGE = DECODING_NAMES["edge"]
DECODING_SUBSTITUTION = DECODING_NAMES["substitution"]
DECODING_EXTERNAL = DECODING_NAMES["external"]
DECODING_ENOCEAN = DECODING_NAMES["enocean"]
DECODING_CUT = DECODING_NAMES["cut"]
DECODING_MORSE = DECODING_NAMES["morse"]


def str2bit(s: str) -> array.array:
    return array.array("B", map(int, s))


def bit2str(bits) -> str:
    return "".join(map(str, bits))


def hex2bit(hex_str: str) -> array.array:
    if not isinstance(hex_str, str):
        return array.array("B", [])
    if hex_str[:2] == "0x":
        hex_str = hex_str[2:]
    try:
        bitstring = "".join("{0:04b}".format(int(h, 16)) for h in hex_str)
        return array.array("B", [x == "1" for x in bitstring])
    except (TypeError, ValueError):
        return array.array("B", [])


def charstr2bit(s: str) -> array.array:
    return array.array("B", [c == "1" for c in s if c in "01"])


def run_command(command: str, param: str = "") -> str:
    """Shlex-aware external program invocation (handles quoted paths with
    spaces and extra arguments, util.py:400-470)."""
    from urh_tpu_torch.util.misc import run_command as _run

    return _run(command, param=param if param else None)


def _rle_bits(bits: np.ndarray):
    """-> (run_values, run_lengths) for a 1-D bit array."""
    if len(bits) == 0:
        return bits, np.zeros(0, dtype=np.int64)
    change = np.flatnonzero(bits[1:] != bits[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [len(bits)]))
    return bits[starts], ends - starts


def _find_pattern(data: np.ndarray, pattern: np.ndarray, last_start: int):
    """First start index of ``pattern`` in ``data`` among starts
    [0, last_start), or None."""
    if last_start <= 0 or len(pattern) == 0 or len(data) < len(pattern):
        return None
    windows = np.lib.stride_tricks.sliding_window_view(
        data[:last_start - 1 + len(pattern)], len(pattern))
    hits = np.flatnonzero(np.all(windows == pattern, axis=1))
    return int(hits[0]) if len(hits) else None


class ErrorState:
    SUCCESS = "success"
    PREAMBLE_NOT_FOUND = "preamble not found"
    SYNC_NOT_FOUND = "sync not found"
    EOF_NOT_FOUND = "eof not found"
    WRONG_INPUT = "wrong input"
    MISSING_EXTERNAL_PROGRAM = "Please set external de/encoder program!"
    INVALID_CUTMARK = "cutmark is not valid"
    MISC = "general error"
    WRONG_PARAMETERS = "wrong parameters"


class Encoding:
    """A named, invertible chain of bit-level coding primitives."""

    ErrorState = ErrorState

    def __init__(self, chain=None):
        if chain is None:
            chain = []

        self.mode = 0
        self.external_decoder = ""
        self.external_encoder = ""
        self.multiple = 1
        self.src = []
        self.dst = []
        self.carrier = "1_"
        self.cutmark = array.array("B", [True, False])
        self.cutmode = 0  # 0 = before, 1 = after, 2 = before_pos, 3 = after_pos
        self.morse_low = 1
        self.morse_high = 3
        self.morse_wait = 1
        self._symbol_len = 1
        self.cc1101_overwrite_crc = False

        # CC1101 data whitening defaults: polynomial x^5+1, sync e9cae9ca
        self.data_whitening_polynomial = str2bit("00100001")
        self.data_whitening_sync = hex2bit("e9cae9ca")
        self.data_whitening_preamble = array.array("B", [True, False] * 16)

        self.chain = []
        self.set_chain(chain)

    # -- chain management -----------------------------------------------
    _PARAM_OPS = {
        "redundancy": 2,
        "data_whitening": "0xe9cae9ca;0x21;0",
        "carrier": "1_",
        "substitution": "0:1;1:0;",
        "external": "./;./",
        "cut": "0;1010",
        "morse": "1;3;1",
    }

    def set_chain(self, names):
        if len(names) < 1:
            return
        self.chain = [names[0]]
        i = 1
        while i < len(names):
            matched = None
            for key, verbose in DECODING_NAMES.items():
                if verbose in names[i]:
                    matched = key
                    break
            if matched is not None:
                op = getattr(self, "code_" + matched)
                self.chain.append(op)
                if matched in self._PARAM_OPS:
                    i += 1
                    if i < len(names):
                        param = names[i]
                        if matched == "substitution":
                            param = self.get_subst_array(param)
                        self.chain.append(param)
                    else:
                        default = self._PARAM_OPS[matched]
                        if matched == "substitution":
                            default = self.get_subst_array(default)
                        self.chain.append(default)
            i += 1

    def get_chain(self):
        chainstr = [self.name]
        i = 1
        while i < len(self.chain):
            op = self.chain[i]
            for key, verbose in DECODING_NAMES.items():
                if op == getattr(self, "code_" + key):
                    chainstr.append(verbose)
                    if key in self._PARAM_OPS:
                        i += 1
                        param = self.chain[i]
                        if key == "substitution":
                            param = self.get_subst_string(param)
                        chainstr.append(param)
                    break
            i += 1
        return chainstr

    @property
    def name(self):
        return self.chain[0]

    @property
    def is_nrz(self) -> bool:
        return len(self.chain) <= 1

    @property
    def contains_cut(self) -> bool:
        return self.code_cut in self.chain

    @property
    def symbol_len(self):
        return int(self._symbol_len)

    def __str__(self):
        return self.name

    def __hash__(self):
        return hash(tuple(str(c) for c in self.get_chain()))

    def __eq__(self, other):
        if other is None:
            return False
        return self.get_chain() == other.get_chain()

    def get_subst_array(self, string):
        src, dst = [], []
        for item in string.split(";"):
            if len(item):
                try:
                    tsrc, tdst = item.split(":")
                    src.append(str2bit(tsrc))
                    dst.append(str2bit(tdst))
                except (ValueError, AttributeError):
                    pass
        return [src, dst]

    def get_subst_string(self, inpt):
        src, dst = inpt[0], inpt[1]
        output = ""
        if len(src) == len(dst):
            for i in range(len(src)):
                output += bit2str(src[i]) + ":" + bit2str(dst[i]) + ";"
        return output

    # -- chain driver (Encoding.py:259-382) ------------------------------
    def code(self, decoding: bool, inputbits):
        temp = array.array("B", inputbits)
        output = temp
        errors = 0
        error_states = []

        if decoding:
            i, ops, step = 0, len(self.chain), 1
        else:
            i, ops, step = len(self.chain) - 1, -1, -1

        while i != ops:
            operation = self.chain[i]
            while not callable(operation) and i + step != ops:
                i += step
                operation = self.chain[i]

            # ops with parameters configure instance state from chain[i+1]
            if operation == self.code_redundancy:
                self.multiple = int(self.chain[i + 1])
            elif operation == self.code_carrier:
                self.carrier = self.chain[i + 1]
            elif operation == self.code_substitution:
                self.src = self.chain[i + 1][0]
                self.dst = self.chain[i + 1][1]
            elif operation == self.code_externalprogram:
                if self.chain[i + 1] != "":
                    try:
                        self.external_decoder, self.external_encoder = self.chain[i + 1].split(";")
                    except ValueError:
                        pass
                else:
                    self.external_decoder, self.external_encoder = "", ""
            elif operation == self.code_data_whitening:
                self._configure_whitening(self.chain[i + 1])
            elif operation == self.code_cut:
                self._configure_cut(self.chain[i + 1])
            elif operation == self.code_morse:
                self._configure_morse(self.chain[i + 1])

            if callable(operation) and len(temp) > 0:
                output, temp_errors, state = operation(decoding, temp)
                errors += temp_errors
                if state != ErrorState.SUCCESS and state not in error_states:
                    error_states.append(state)

            i += step
            temp = output

        if len(inputbits):
            self._symbol_len = len(output) / len(inputbits)

        error_state = error_states[0] if error_states else ErrorState.SUCCESS
        return output, errors, error_state

    def encode(self, inpt):
        return self.code(False, inpt)[0]

    def decode(self, inpt):
        return self.code(True, inpt)[0]

    def applies_for_message(self, msg) -> bool:
        errors, state = self.analyze(msg)
        return errors == 0 and state == ErrorState.SUCCESS

    def analyze(self, inpt):
        return self.code(True, inpt)[1:3]

    def _configure_whitening(self, param: str):
        if param.count(";") == 2:
            sync, poly, overwrite_crc = param.split(";")
            if len(sync) > 0 and len(poly) > 0 and len(overwrite_crc) > 0:
                self.data_whitening_sync = hex2bit(sync)
                self.data_whitening_polynomial = hex2bit(poly)
                self.cc1101_overwrite_crc = overwrite_crc == "1"
        elif param.count(";") == 1:
            sync, poly = param.split(";")
            if len(sync) > 0 and len(poly) > 0:
                self.data_whitening_sync = hex2bit(sync)
                self.data_whitening_polynomial = hex2bit(poly)
                self.cc1101_overwrite_crc = False

    def _configure_cut(self, param: str):
        if param != "" and param.count(";") == 1:
            cutmode, tmp = param.split(";")
            self.cutmode = int(cutmode)
            if self.cutmode < 0 or self.cutmode > 3:
                self.cutmode = 0
            if self.cutmode in (0, 1):
                self.cutmark = str2bit(tmp)
                if len(self.cutmark) == 0:
                    self.cutmark = array.array("B", [True, False, True, False])
            else:
                try:
                    self.cutmark = int(tmp)
                except ValueError:
                    self.cutmark = 1

    def _configure_morse(self, param: str):
        if param != "" and param.count(";") == 2:
            try:
                l, h, w = param.split(";")
                self.morse_low, self.morse_high, self.morse_wait = int(l), int(h), int(w)
            except ValueError:
                self.morse_low, self.morse_high, self.morse_wait = 1, 3, 1

    # -- primitives (vectorized bit-plane ops) ---------------------------
    @staticmethod
    def _bits(inpt) -> np.ndarray:
        return np.asarray(inpt, dtype=np.uint8)

    @staticmethod
    def _out(arr) -> array.array:
        return array.array("B", np.asarray(arr, dtype=np.uint8))

    def code_invert(self, decoding, inpt):
        return self._out(self._bits(inpt) ^ 1), 0, ErrorState.SUCCESS

    def code_differential(self, decoding, inpt):
        bits = self._bits(inpt)
        if decoding:
            # transition detector: out[i] = in[i] != in[i-1]
            out = np.concatenate((bits[:1], bits[1:] ^ bits[:-1]))
        else:
            # inverse = running parity (XOR prefix scan)
            out = np.bitwise_xor.accumulate(bits)
        return self._out(out), 0, ErrorState.SUCCESS

    def code_redundancy(self, decoding, inpt):
        if not len(inpt) or self.multiple <= 1:
            return array.array("B", []), 0, ErrorState.SUCCESS
        bits = self._bits(inpt)
        if not decoding:
            return self._out(np.repeat(bits, self.multiple)), 0, ErrorState.SUCCESS
        # run-level: each same-value run of length L yields L // multiple
        # bits; a run interrupted with a partial group pending counts one
        # error (final run excluded — no interrupting flip follows it).
        values, lengths = _rle_bits(bits)
        reps = lengths // self.multiple
        out = np.repeat(values, reps)
        errors = int(np.count_nonzero(lengths[:-1] % self.multiple))
        return self._out(out), errors, ErrorState.SUCCESS

    def code_carrier(self, decoding, inpt):
        """Interleave/deinterleave payload bits with a repeating carrier
        pattern; '0'/'1' are fixed carrier cells (checked when decoding),
        any other character is a payload slot."""
        if len(self.carrier) == 0:
            return array.array("B", []), 0, ErrorState.SUCCESS
        pattern = np.frombuffer(self.carrier.encode(), dtype=np.uint8)
        is_fixed = (pattern == ord("0")) | (pattern == ord("1"))
        is_data = ~is_fixed & (pattern != ord("*"))

        if decoding:
            bits = self._bits(inpt)
            tiled = np.resize(pattern, len(bits))
            data_mask = np.resize(is_data, len(bits))
            check_mask = np.resize(is_fixed, len(bits))
            expected = (tiled == ord("1")).astype(np.uint8)
            errors = int(np.count_nonzero(bits[check_mask]
                                          != expected[check_mask]))
            return self._out(bits[data_mask]), errors, ErrorState.SUCCESS

        # encoding: scatter payload bits into successive data slots of a
        # tiled pattern; after the last payload bit, carrier cells are
        # emitted up to the next data slot or period boundary
        bits = self._bits(inpt)
        slots_per_period = int(np.count_nonzero(is_data))
        if slots_per_period == 0:
            return array.array("B", []), 1, ErrorState.WRONG_PARAMETERS
        periods = -(-max(len(bits), 1) // slots_per_period)
        total = periods * len(pattern)
        cells = np.resize((pattern == ord("1")).astype(np.uint8), total)
        slots = np.flatnonzero(np.resize(is_data, total))
        cells[slots[:len(bits)]] = bits

        end = int(slots[len(bits) - 1]) + 1 if len(bits) else 0
        while end % len(pattern) != 0 and not is_data[end % len(pattern)]:
            end += 1
        return self._out(cells[:end]), 0, ErrorState.SUCCESS

    def code_lsb_first(self, decoding, inpt):
        bits = self._bits(inpt)
        whole = len(bits) - len(bits) % 8
        flipped = bits[:whole].reshape(-1, 8)[:, ::-1].reshape(-1)
        out = np.concatenate((flipped, bits[whole:]))
        return self._out(out), len(bits) % 8, ErrorState.SUCCESS

    # alias matching the chain-name key "bitorder"
    code_bitorder = code_lsb_first

    def code_edge(self, decoding, inpt):
        bits = self._bits(inpt)
        if not decoding:
            # each bit becomes a (complement, bit) transition pair
            out = np.empty(2 * len(bits), dtype=np.uint8)
            out[0::2] = bits ^ 1
            out[1::2] = bits
            return self._out(out), 0, ErrorState.SUCCESS
        pairs = bits[:2 * (len(bits) // 2)].reshape(-1, 2)
        if len(pairs) and np.all(pairs[:, 0] != pairs[:, 1]):
            # clean Manchester stream: second half of every pair is the bit
            return self._out(pairs[:, 1]), 0, ErrorState.SUCCESS
        # resynchronizing fallback for streams with coding violations
        output, errors, i = array.array("B", []), 0, 1
        while i < len(bits):
            if bits[i] == bits[i - 1]:
                errors += 1
                i += 1
            else:
                output.append(int(bits[i]))
                i += 2
        return output, errors, ErrorState.SUCCESS

    def code_substitution(self, decoding, inpt):
        src, dst = (self.src, self.dst) if decoding else (self.dst, self.src)
        if len(src) < 1 or len(dst) < 1:
            return [], 1, ErrorState.WRONG_INPUT

        item_size = len(src[0])
        # word -> replacement; words listed more than once are ambiguous
        # and consumed without output (reference count semantics)
        table, ambiguous = {}, set()
        for word, repl in zip(src, dst):
            key = bytes(word)
            if key in table:
                ambiguous.add(key)
            table[key] = repl

        bits = self._bits(inpt)
        pad = (item_size - len(bits) % item_size) % item_size
        bits = np.concatenate((bits, np.zeros(pad, np.uint8)))
        errors = pad

        output, pos = array.array("B", []), 0
        while pos < len(bits):
            word = bits[pos:pos + item_size].tobytes()
            if word in ambiguous:
                pos += item_size
            elif word in table:
                output.extend(table[word])
                pos += item_size
            else:
                # resync bit by bit on unknown words
                output.append(int(bits[pos]))
                pos += 1
                errors += 1
        return output, errors, ErrorState.SUCCESS

    def code_externalprogram(self, decoding, inpt):
        if decoding and self.external_decoder != "":
            output = charstr2bit(run_command(self.external_decoder, bit2str(inpt)))
        elif not decoding and self.external_encoder != "":
            output = charstr2bit(run_command(self.external_encoder, bit2str(inpt)))
        else:
            return [], 1, ErrorState.MISSING_EXTERNAL_PROGRAM
        return output, 0, ErrorState.SUCCESS

    code_external = code_externalprogram

    def code_cut(self, decoding, inpt):
        errors = 0
        state = ErrorState.SUCCESS
        output = array.array("B", [])
        pos = -1
        if decoding:
            if self.cutmode in (0, 1):
                mark = self._bits(self.cutmark)
                if len(mark) < 1:
                    return inpt, 0, ErrorState.INVALID_CUTMARK
                hit = _find_pattern(self._bits(inpt), mark,
                                    len(inpt) - len(mark))
                pos = hit if hit is not None else -1
            else:
                pos = int(self.cutmark)

            if 0 <= pos < len(inpt):
                if self.cutmode in (0, 2):
                    output.extend(inpt[pos:])  # delete before
                else:
                    pos += len(self.cutmark) if self.cutmode == 1 else 1
                    output.extend(inpt[:pos])  # delete after
            else:
                state = ErrorState.PREAMBLE_NOT_FOUND
                output.extend(inpt)
        else:
            # cutting is lossy; encoding passes through
            output.extend(inpt)
        return output, errors, state

    def code_morse(self, decoding, inpt):
        errors = 0
        output = array.array("B", [])
        if self.morse_low >= self.morse_high:
            return inpt, 1, ErrorState.WRONG_PARAMETERS

        if decoding:
            # run-level: every run of ones is one mark, classified by length
            values, lengths = _rle_bits(self._bits(inpt))
            marks = lengths[values == 1]
            dash = marks >= self.morse_high
            dot = marks <= self.morse_low
            ambiguous = ~dash & ~dot
            bits = np.where(
                dash, 1,
                np.where(dot, 0,
                         marks > (self.morse_high + self.morse_low // 2)))
            errors = int(np.count_nonzero(ambiguous))
            return self._out(bits), errors, ErrorState.SUCCESS

        # mark length per bit, with a wait gap before each and one after all
        bits = self._bits(inpt)
        mark_lens = np.where(bits, self.morse_high, self.morse_low)
        lengths = np.empty(2 * len(bits) + 1, dtype=np.int64)
        lengths[0::2] = self.morse_wait
        lengths[1::2] = mark_lens
        symbols = np.zeros(2 * len(bits) + 1, dtype=np.uint8)
        symbols[1::2] = 1
        return self._out(np.repeat(symbols, lengths)), errors, ErrorState.SUCCESS

    # -- CC1101 data whitening --------------------------------------------
    # Keystream convention (matching Encoding.py:384-472 bit for bit):
    # after every 8 clocks of the Fibonacci LFSR the *register contents*
    # (minus the feedback cell) are appended to the keystream — the
    # stream is a sequence of register snapshots, not tap outputs.

    def _whitening_keystream(self, num_bits: int) -> np.ndarray:
        """Vectorized keystream: snapshots of an all-ones-seeded LFSR,
        one per 8 clocks, until ``num_bits`` are covered.  Returns None
        when the register is too small to keep up with the data rate."""
        taps = np.asarray(self.data_whitening_polynomial, dtype=np.uint8)
        width = len(taps) + 1  # feedback cell + register
        snapshots = 1 + -(-num_bits // 8)  # initial + one per byte
        if (width - 1) * snapshots < num_bits:
            return None

        state = np.ones(width, dtype=np.uint8)
        mask = np.concatenate(([0], taps)).astype(bool)
        stream = np.empty((snapshots, width - 1), dtype=np.uint8)
        stream[0] = state[1:]
        for row in range(1, snapshots):
            for _ in range(8):
                feedback = np.bitwise_xor.reduce(state[mask]) if mask.any() else 0
                state[1:] = state[:-1]
                state[0] = feedback
            stream[row] = state[1:]
        return stream.reshape(-1)[:num_bits]

    def _find_whitening_start(self, data: np.ndarray) -> int:
        """Index right after the first sync-word occurrence, or 0.  The
        scan excludes a sync ending exactly at the data end (reference
        range semantics)."""
        sync = np.asarray(self.data_whitening_sync, dtype=np.uint8)
        hit = _find_pattern(data, sync, len(data) - len(sync))
        return hit + len(sync) if hit is not None else 0

    def apply_data_whitening(self, decoding, inpt):
        data = np.asarray(inpt, dtype=np.uint8).copy()
        if decoding and len(data) > 1 and data[-1] == data[-2]:
            data = data[:-1]  # crop the duplicated trailing bit

        if (len(data) < 1 or len(self.data_whitening_polynomial) < 1
                or len(self.data_whitening_sync) < 1):
            return array.array("B", data), 0, ErrorState.MISC

        start = self._find_whitening_start(data)
        if decoding and start == 0:
            return array.array("B", data), 0, ErrorState.SYNC_NOT_FOUND

        keystream = self._whitening_keystream(len(data) - start)
        if keystream is None:
            return array.array("B", data), 0, ErrorState.MISC

        if not decoding and self.cc1101_overwrite_crc:
            from urh_tpu_torch.coding.crc import GenericCRC

            crc_at = len(data) - 16 - len(data) % 8
            crc = GenericCRC(polynomial="16_standard", start_value=True)
            data[crc_at:crc_at + 16] = np.asarray(
                crc.crc(data[start:crc_at].tolist()), dtype=np.uint8)

        data[start:] ^= keystream
        if not decoding:
            data = np.append(data, data[-1])  # duplicate the trailing bit

        return array.array("B", data), 0, ErrorState.SUCCESS

    def code_data_whitening(self, decoding, inpt):
        return self.apply_data_whitening(decoding, inpt)

    # -- EnOcean WSP line code (Encoding.py:794-898) ---------------------
    def code_enocean(self, decoding, inpt):
        errors = 0
        output = array.array("B", [])
        preamble = str2bit("10101010")
        sof = str2bit("1001")
        eof = str2bit("1011")

        if decoding:
            inpt, _, _ = self.code_invert(True, inpt)
            # the first (inverted) 1 of EnOcean is weak and often drowns in
            # noise: ensure the protocol starts with 1
            inpt.insert(0, True)
            # zero-noise signals (fuzzer output) swallow the last two zeros
            inpt.extend([True, True])

        try:
            n = inpt.index(False) - 1
        except ValueError:
            return inpt, 0, ErrorState.PREAMBLE_NOT_FOUND

        if inpt[n : n + 8] != preamble:
            return inpt, 0, ErrorState.PREAMBLE_NOT_FOUND
        if inpt[n + 8 : n + 12] != sof:
            return inpt, 0, ErrorState.SYNC_NOT_FOUND
        output.extend(inpt[n : n + 12])

        start = n + 12
        n = len(inpt)
        while n > start and inpt[n - 4 : n] != eof:
            n -= 1
        end = n - 4

        state = ErrorState.SUCCESS
        if decoding:
            try:
                for n in range(start, end, 12):
                    errors += sum([inpt[n + 2] == inpt[n + 3], inpt[n + 6] == inpt[n + 7]])
                    errors += (
                        sum([inpt[n + 10] != False, inpt[n + 11] != True])
                        if n < end - 11
                        else 0
                    )
                    output.extend(
                        [inpt[n], inpt[n + 1], inpt[n + 2], inpt[n + 4],
                         inpt[n + 5], inpt[n + 6], inpt[n + 8], inpt[n + 9]]
                    )
            except IndexError:
                return inpt, 0, ErrorState.MISC
            output.extend(inpt[end : end + 4])
        else:
            for n in range(start, end, 8):
                try:
                    output.extend(
                        [inpt[n], inpt[n + 1], inpt[n + 2], not inpt[n + 2],
                         inpt[n + 3], inpt[n + 4], inpt[n + 5], not inpt[n + 5],
                         inpt[n + 6], inpt[n + 7]]
                    )
                except IndexError:
                    output.extend([False, True])
                    break
                if n < len(inpt) - 15:
                    output.extend([False, True])
            output.extend(eof)
            output.append(True)
            output, _, _ = self.code_invert(True, output)

        return output, errors, state

    # -- persistence -----------------------------------------------------
    @staticmethod
    def decodings_to_xml_tag(decodings: list) -> ET.Element:
        decodings_tag = ET.Element("decodings")
        for decoding in decodings:
            dec_str = ""
            for chn in decoding.get_chain():
                dec_str += repr(chn) + ", "
            dec_tag = ET.SubElement(decodings_tag, "decoding")
            dec_tag.text = dec_str
        return decodings_tag

    @staticmethod
    def read_decoders_from_xml_tag(xml_tag: ET.Element):
        if xml_tag is None:
            return []
        if xml_tag.tag != "decodings":
            xml_tag = xml_tag.find("decodings")
        if xml_tag is None:
            return []
        decoders = []
        for decoding_tag in xml_tag.findall("decoding"):
            conf = [d.strip().replace("'", "") for d in decoding_tag.text.split(",")]
            decoders.append(Encoding(conf))
        return decoders
