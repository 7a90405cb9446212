"""ProtocolAnalyzerContainer: protocol management + fuzzing for TX.

Role of urh/signalprocessing/ProtocolAnalyzerContainer.py, restructured
around a strategy table: each fuzz mode is a pure generator over
``(start, end, value)`` substitution tuples, and one engine applies any
strategy to the message list.  Includes a de Bruijn generator for
exhaustive coverage sequences (urh/cythonext/util.pyx:306-340).
"""

from __future__ import annotations

import array
import copy
import itertools
from enum import Enum

from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer
from urh_tpu_torch.protocol.labels import ProtocolLabel
from urh_tpu_torch.protocol.message import Message


class FuzzMode(Enum):
    successive = 0
    concurrent = 1
    exhaustive = 2


def de_bruijn(n: int) -> array.array:
    """Binary de Bruijn sequence B(2, n): every n-bit value appears exactly
    once as a cyclic substring.  Iterative Duval construction — the
    concatenation, in lexicographic order, of the binary Lyndon words
    whose length divides n (the reference recurses in C)."""
    sequence = array.array("B", [])
    word = [0]
    while word:
        if n % len(word) == 0:
            sequence.extend(word)
        # successor Lyndon word: repeat periodically to length n, strip
        # trailing max symbols, increment the last remaining one
        word = (word * (n // len(word) + 1))[:n]
        while word and word[-1] == 1:
            word.pop()
        if word:
            word[-1] += 1
    return sequence


# --- fuzz strategies: labels -> iterable of substitution combinations -----
# A combination is a list of (start, end, bit_string) applied to one copy
# of the message.  fuzz_values[0] is each label's default and never fuzzed.


def _successive(labels):
    """One label varies at a time, all others stay at their default."""
    return ([(lbl.start, lbl.end, value)]
            for lbl in labels for value in lbl.fuzz_values[1:])


def _concurrent(labels):
    """All labels step together; exhausted ones fall back to default."""
    rounds = max((len(lbl.fuzz_values) for lbl in labels), default=0)
    return ([(lbl.start, lbl.end,
              lbl.fuzz_values[j] if j < len(lbl.fuzz_values) else lbl.fuzz_values[0])
             for lbl in labels]
            for j in range(1, rounds))


def _exhaustive(labels):
    """Cross product over every label's fuzz values."""
    if not labels:
        return iter(())
    return itertools.product(*([(lbl.start, lbl.end, value)
                                for value in lbl.fuzz_values[1:]]
                               for lbl in labels))


_STRATEGIES = {
    FuzzMode.successive: _successive,
    FuzzMode.concurrent: _concurrent,
    FuzzMode.exhaustive: _exhaustive,
}


class ProtocolAnalyzerContainer(ProtocolAnalyzer):
    """Manages multiple protocols for the generator and performs fuzzing."""

    def __init__(self):
        super().__init__(None, filename="")
        self.fuzz_pause = 10000

    @property
    def protocol_labels(self):
        return sorted({lbl for msg in self.messages for lbl in msg.message_type})

    @property
    def pauses(self):
        return [msg.pause for msg in self.messages]

    @property
    def multiple_fuzz_labels_per_message(self):
        return any(len(msg.active_fuzzing_labels) > 1 for msg in self.messages)

    def insert_protocol_analyzer(self, index: int, proto_analyzer: ProtocolAnalyzer):
        clones = [Message(plain_bits=msg.decoded_bits, pause=msg.pause,
                          message_type=copy.copy(msg.message_type), rssi=msg.rssi,
                          modulator_index=0, decoder=msg.decoder,
                          samples_per_symbol=msg.samples_per_symbol,
                          participant=msg.participant,
                          bits_per_symbol=msg.bits_per_symbol)
                  for msg in proto_analyzer.messages]
        self.messages[index:index] = clones
        if self.pauses:
            self.fuzz_pause = self.pauses[0]

    def duplicate_lines(self, rows: list):
        insert_at = max(rows) + 1
        for row in reversed(rows):
            self.messages.insert(insert_at, copy.deepcopy(self.messages[row]))

    @staticmethod
    def _defused_message_type(message_type, labels):
        """Copy of the message type whose fuzzed labels are marked
        fuzz_created with their value lists cleared."""
        clone = copy.copy(message_type)
        for lbl in labels:
            spent = copy.copy(lbl)
            spent.fuzz_values = []
            spent.fuzz_created = True
            clone[clone.index(spent)] = spent
        return clone

    def fuzz(self, mode: FuzzMode, default_pause=None):
        fuzzed_indices = []
        out = []
        for msg in self.messages:
            out.append(msg)
            labels = msg.active_fuzzing_labels
            message_type = self._defused_message_type(msg.message_type, labels)
            pause = msg.pause if default_pause is None else default_pause

            for combination in _STRATEGIES[mode](labels):
                bits = msg.plain_bits[:]
                for start, end, value in combination:
                    bits[start:end] = array.array("B", map(int, value))
                out.append(Message(plain_bits=bits, pause=pause, rssi=msg.rssi,
                                   message_type=message_type,
                                   modulator_index=msg.modulator_index,
                                   decoder=msg.decoder, fuzz_created=True,
                                   participant=msg.participant))
                # true index in the NEW list (the reference reports i+j+1
                # relative to the old list, which mis-targets undo deletes
                # as soon as more than one message gets fuzzed)
                fuzzed_indices.append(len(out) - 1)

        self.messages = out
        return fuzzed_indices

    def fuzz_successive(self, default_pause=None):
        """One label fuzzed at a time; all others stay at their default."""
        return self.fuzz(FuzzMode.successive, default_pause=default_pause)

    def fuzz_concurrent(self, default_pause=None):
        """All labels iterate simultaneously; exhausted labels fall back to
        their first (default) value."""
        return self.fuzz(FuzzMode.concurrent, default_pause=default_pause)

    def fuzz_exhaustive(self, default_pause=None):
        """Cross product of all label fuzz values."""
        return self.fuzz(FuzzMode.exhaustive, default_pause=default_pause)

    def create_fuzzing_label(self, start, end, msg_index) -> ProtocolLabel:
        return self.messages[msg_index].message_type.add_protocol_label(
            start=start, end=end)

    def set_decoder_for_messages(self, decoder, messages=None):
        raise NotImplementedError("encoding can't be set in generator")

    def to_xml_file(self, filename: str, decoders, participants,
                    tag_name="fuzz_profile", include_message_types=True,
                    write_bits=True, modulators=None):
        super().to_xml_file(filename=filename, decoders=decoders,
                            participants=participants, tag_name=tag_name,
                            include_message_types=include_message_types,
                            write_bits=write_bits, modulators=modulators)

    def from_xml_file(self, filename: str, read_bits=True):
        super().from_xml_file(filename=filename, read_bits=read_bits)

    @classmethod
    def from_string(cls, message_strings, is_hex=False, default_pause=0,
                    sample_rate=1e6):
        pa = ProtocolAnalyzer.get_protocol_from_string(
            message_strings, is_hex=is_hex, default_pause=default_pause,
            sample_rate=sample_rate)
        container = cls()
        container.messages = pa.messages
        return container

    def clear(self):
        self.messages[:] = []
