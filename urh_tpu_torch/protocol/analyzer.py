"""ProtocolAnalyzer: signal -> messages, plus protocol-level operations.

PyTorch port of urh_tpu.protocol.analyzer, the counterpart of
urh/signalprocessing/ProtocolAnalyzer.py (898 LoC).  The sample-rate
stages (quadrature demod, symbol states, their run-length encoding) run
on the signal's device; the pulse-sequence -> bit conversion and
protocol bookkeeping are host work.  Includes view conversion, message
alignment, XML export and string parsing with pause syntax.
"""

from __future__ import annotations

import array
import copy
import xml.etree.ElementTree as ET
from xml.dom import minidom

import numpy as np

from urh_tpu_torch.coding.encodings import Encoding, hex2bit
from urh_tpu_torch.dsp import symbols as _symbols
from urh_tpu_torch.protocol.labels import MessageType, Participant
from urh_tpu_torch.protocol.message import Message

PAUSE_TYPE = -1
PAUSE_SEP = "/"


def number_to_bits(n: int, length: int):
    return array.array("B", map(int, format(n, f"0{length}b")))


def ascii2bit(ascii_str: str) -> array.array:
    return array.array("B", (int(b) for c in ascii_str for b in "{0:08b}".format(ord(c))))


def aggregate_bits(bits, size=8):
    result = []
    for i in range(0, len(bits), size):
        h = 0
        for j in range(size):
            if i + j < len(bits):
                h = (h << 1) | bits[i + j]
            else:
                h <<= 1
        result.append(h)
    return result


class ProtocolAnalyzer:
    def __init__(self, signal=None, filename=None):
        self.messages = []
        self.signal = signal
        if filename is None:
            self.filename = self.signal.filename if self.signal is not None else ""
        else:
            assert signal is None
            self.filename = filename

        import os

        self._name = os.path.splitext(os.path.basename(self.filename))[0] if self.filename else "Blank"
        self.show = True
        self.decoder = Encoding(["Non Return To Zero (NRZ)"])
        self.message_types = [MessageType("Default")]

    # -- naming / types ---------------------------------------------------
    @property
    def name(self):
        return self.signal.name if self.signal is not None else self._name

    @name.setter
    def name(self, value: str):
        if self.signal is None:
            self._name = value
        else:
            self.signal.name = value

    @property
    def default_message_type(self) -> MessageType:
        if len(self.message_types) == 0:
            self.message_types.append(MessageType("Default"))
        return self.message_types[0]

    @default_message_type.setter
    def default_message_type(self, val: MessageType):
        if len(self.message_types) > 0:
            self.message_types[0] = val
        else:
            self.message_types.append(val)

    @property
    def protocol_labels(self):
        return [lbl for message_type in self.message_types for lbl in message_type]

    def __deepcopy__(self, memo):
        cls = self.__class__
        result = cls.__new__(cls)
        memo[id(self)] = result
        for k, v in self.__dict__.items():
            if k != "signal":
                setattr(result, k, copy.deepcopy(v, memo))
        result.signal = self.signal
        return result

    # -- views ------------------------------------------------------------
    def _collect(self, message_attr: str) -> list:
        return [getattr(msg, message_attr) for msg in self.messages]

    plain_bits_str = property(lambda self: self._collect("plain_bits_str"))
    decoded_proto_bits_str = property(lambda self: self._collect("decoded_bits_str"))
    plain_hex_str = property(lambda self: self._collect("plain_hex_str"))
    decoded_hex_str = property(lambda self: self._collect("decoded_hex_str"))
    decoded_ascii_str = property(lambda self: self._collect("decoded_ascii_str"))

    @property
    def num_messages(self) -> int:
        return sum(1 for m in self.messages if m)

    def clear_decoded_bits(self):
        for msg in self.messages:
            msg.clear_decoded_bits()

    def decoded_to_str_list(self, view_type):
        return self._collect(
            ("decoded_bits_str", "decoded_hex_str", "decoded_ascii_str")[view_type])

    def plain_to_string(self, view: int, show_pauses=True) -> str:
        time = self.signal.sample_rate if self.signal else None
        return "\n".join(
            msg.view_to_string(view=view, decoded=False, show_pauses=show_pauses,
                               sample_rate=time)
            for msg in self.messages
        )

    def set_decoder_for_messages(self, decoder: Encoding, messages=None):
        messages = messages if messages is not None else self.messages
        self.decoder = decoder
        for message in messages:
            message.decoder = decoder

    # -- demodulation (hot path) -----------------------------------------
    def get_protocol_from_signal(self):
        signal = self.signal
        if signal is None:
            self.messages = None
            return

        if self.messages is not None:
            self.messages[:] = []
        else:
            self.messages = []
        params = signal.params

        # cheapest route to symbol states: int8 fused kernel avoids qad
        # entirely; float32 fused kernel computes both; host path derives
        # states from qad
        states = (signal.fast_symbol_states()
                  if hasattr(signal, "fast_symbol_states") else None)
        qad = None if states is not None and signal._qad is None else signal.qad
        ppseq = _symbols.grab_pulse_lens(
            qad,
            params.center,
            params.tolerance,
            params.modulation,
            params.samples_per_symbol,
            params.bits_per_symbol,
            params.center_spacing,
            precomputed_states=states,
        )

        bit_data, pauses, bit_sample_pos = self._ppseq_to_bits(
            ppseq, params.samples_per_symbol, params.bits_per_symbol,
            pause_threshold=params.pause_threshold,
        )
        if params.message_length_divisor > 1 and params.modulation == "ASK":
            self._ensure_message_length_multiple(
                bit_data, params.samples_per_symbol, pauses, bit_sample_pos,
                params.message_length_divisor,
            )

        for i, (bits, pause) in enumerate(zip(bit_data, pauses)):
            middle_bit_pos = bit_sample_pos[i][int(len(bits) / 2)]
            start, end = middle_bit_pos, middle_bit_pos + params.samples_per_symbol
            rssi = np.mean(signal.iq_array.subarray(start, end).magnitudes_normalized)
            timestamp = signal.timestamp + bit_sample_pos[i][0] / params.sample_rate
            self.messages.append(
                Message(bits, pause,
                        message_type=self.default_message_type,
                        samples_per_symbol=params.samples_per_symbol,
                        rssi=rssi, decoder=self.decoder,
                        bit_sample_pos=bit_sample_pos[i],
                        bits_per_symbol=params.bits_per_symbol,
                        timestamp=timestamp)
            )
        return self.messages

    @staticmethod
    def _ensure_message_length_multiple(bit_data, samples_per_symbol, pauses,
                                        bit_sample_pos, divisor):
        """Use pause samples as trailing zero bits so ASK message lengths hit
        a multiple of ``divisor`` (ProtocolAnalyzer.py:289-321)."""
        for bits, positions, i in zip(bit_data, bit_sample_pos,
                                      range(len(bit_data))):
            missing = -len(bits) % divisor
            if missing == 0 or pauses[i] < samples_per_symbol * missing:
                continue
            bits.extend(bytes(missing))
            pauses[i] -= missing * samples_per_symbol
            try:
                positions[-1] = positions[-2] + samples_per_symbol
            except IndexError:
                continue
            positions.extend(positions[-1] + (k + 1) * samples_per_symbol
                             for k in range(missing - 1))
            positions.append(positions[-1] + pauses[i])

    @staticmethod
    def _ppseq_to_bits(ppseq, samples_per_symbol: int, bits_per_symbol: int,
                       write_bit_sample_pos=True, pause_threshold=8):
        """Pulse (state, length) runs -> per-message bit arrays + pauses.

        Vectorized reformulation of the reference's per-run accumulator
        loop (ProtocolAnalyzer.py:323-414): long pauses partition the
        run list into segments, and each segment expands to bits through
        array ops (np.repeat for symbol expansion, one shift-and-mask
        for symbol->bit unpacking, arithmetic for per-bit sample
        positions).  Semantics preserved exactly:

        * symbol count per run rounds half-DOWN (frac must exceed 0.5)
        * a leading pause run is consumed without emitting zero bits
        * short pauses (<= pause_threshold symbols, or always when the
          threshold is 0) become OOK zero bits inside the message
        * segments without any data run are dropped entirely
        * a trailing short pause stays in the bits AND reports as the
          final message's pause length (reference quirk)
        """
        messages, pauses, positions = [], array.array("L", []), []
        n_runs = len(ppseq)
        if n_runs == 0:
            return messages, pauses, positions

        run_type = np.asarray(ppseq[:, 0], dtype=np.int64)
        run_len = np.asarray(ppseq[:, 1], dtype=np.int64)
        ratio = run_len / samples_per_symbol
        n_sym = ratio.astype(np.int64)
        n_sym += (ratio - n_sym) > 0.5

        is_pause = run_type == PAUSE_TYPE
        splits = is_pause & (n_sym > pause_threshold) & (pause_threshold != 0)
        run_start = np.cumsum(run_len) - run_len
        total_samples = int(run_len.sum())
        samples_per_bit = samples_per_symbol // bits_per_symbol
        shifts = np.arange(bits_per_symbol - 1, -1, -1, dtype=np.int64)

        # segment boundaries: [seg_lo, seg_hi) of runs, split at long pauses
        boundaries = np.flatnonzero(splits)
        seg_lo = 0 if not is_pause[0] else 1  # leading pause emits nothing
        for seg_hi in list(boundaries) + [n_runs]:
            if seg_hi <= seg_lo:
                seg_lo = seg_hi + 1
                continue
            sl = slice(seg_lo, seg_hi)
            seg_lo = seg_hi + 1

            seg_sym = n_sym[sl]
            has_data = bool(np.any(~is_pause[sl] & (seg_sym > 0)))
            if not has_data:
                continue

            # expand runs to symbols to bits (pauses are zero-valued)
            sym_vals = np.repeat(np.where(is_pause[sl], 0, run_type[sl]), seg_sym)
            bits = ((sym_vals[:, None] >> shifts) & 1).astype(np.uint8).ravel()
            messages.append(array.array("B", bits.tobytes()))

            if write_bit_sample_pos:
                counts = seg_sym * bits_per_symbol
                starts = np.repeat(run_start[sl], counts)
                intra = np.arange(int(counts.sum()), dtype=np.int64) \
                    - np.repeat(np.cumsum(counts) - counts, counts)
                pos = array.array("L", [])
                pos.frombytes((starts + intra * samples_per_bit).astype(
                    f"=u{pos.itemsize}").tobytes())

            if seg_hi < n_runs:  # closed by a long pause
                pause = int(run_len[seg_hi])
                if write_bit_sample_pos:
                    pos.extend((int(run_start[seg_hi]),
                                int(run_start[seg_hi]) + pause))
            else:  # capture ended mid-message
                pause = int(run_len[-1]) if is_pause[-1] else 0
                if write_bit_sample_pos:
                    pos.append(total_samples)
            pauses.append(pause)
            if write_bit_sample_pos:
                positions.append(pos)

        return messages, pauses, positions

    # -- sample <-> bit mapping (ProtocolAnalyzer.py:416-487) ------------
    def get_samplepos_of_bitseq(self, start_message: int, start_index: int,
                                end_message: int, end_index: int, include_pause: bool):
        def clamped_pos(msg_index: int, bit_index: int) -> int:
            positions = self.messages[msg_index].bit_sample_pos
            limit = len(positions) - 1
            if bit_index >= limit:
                bit_index = limit if include_pause else limit - 1
            return positions[bit_index]

        try:
            if start_message > end_message:
                start_message, end_message = end_message, start_message
            start = clamped_pos(start_message, start_index)
            return start, clamped_pos(end_message, end_index) - start
        except (KeyError, IndexError):
            return -1, -1

    def get_bitseq_from_selection(self, selection_start: int, selection_width: int):
        """Sample selection -> (start msg, start bit, end msg, end bit),
        via binary search over each message's sorted bit_sample_pos
        (replaces the reference's per-bit linear scan,
        ProtocolAnalyzer.py:445-487)."""
        if not self.messages or not self.messages[0].bit_sample_pos:
            return -1, -1, -1, -1
        if selection_start + selection_width < self.messages[0].bit_sample_pos[0]:
            return -1, -1, -1, -1

        sel_end = selection_start + selection_width
        start_message, start_index = -1, -1
        for i, msg in enumerate(self.messages):
            pos = np.asarray(msg.bit_sample_pos)
            if pos[-2] < selection_start:
                continue
            if start_message == -1:
                start_message = i
                # first bit position at/after the selection start
                start_index = int(np.searchsorted(pos, selection_start))
                if pos[-1] - selection_start < selection_width:
                    continue  # message entirely inside: end is further right
                # first later position strictly beyond the selection
                j = max(int(np.searchsorted(pos, sel_end, side="right")),
                        start_index + 1)
                if j < len(pos):
                    return start_message, start_index, i, j
            elif pos[-1] - selection_start >= selection_width:
                j = int(np.searchsorted(pos, sel_end, side="right"))
                if j < len(pos):
                    return start_message, start_index, i, j

        return (start_message, start_index, len(self.messages) - 1,
                len(self.messages[-1].plain_bits) + 1)

    # -- editing ----------------------------------------------------------
    def delete_messages(self, msg_start: int, msg_end: int, start: int, end: int,
                        view: int, decoded: bool, update_label_ranges=True):
        emptied = []
        for i in range(msg_start, msg_end + 1):
            try:
                bs, be = self.convert_range(start, end, view, 0, decoded,
                                            message_indx=i)
                message = self.messages[i]
            except IndexError:
                continue
            message.clear_decoded_bits()
            if update_label_ranges:
                del message[bs : be + 1]
            else:
                message.delete_range_without_label_range_update(bs, be + 1)
            if len(message) == 0:
                emptied.append(i)
        for i in reversed(emptied):
            del self.messages[i]
        return emptied

    def _reference_message(self, message_indx: int):
        """Message whose view widths anchor an index conversion: the
        longest one unless an explicit index is given."""
        if message_indx == -1:
            message_indx = self.messages.index(max(self.messages, key=len))
        return self.messages[min(message_indx, len(self.messages) - 1)]

    def convert_index(self, index, from_view, to_view, decoded, message_indx=-1):
        if not self.messages:
            return 0, 0
        return self._reference_message(message_indx).convert_index(
            index, from_view, to_view, decoded)

    def convert_range(self, index1, index2, from_view, to_view, decoded,
                      message_indx=-1):
        if not self.messages:
            return 0, 0
        return self._reference_message(message_indx).convert_range(
            index1, index2, from_view, to_view, decoded)

    _PATTERN_TO_BITS = {
        0: lambda p: p,
        1: lambda p: "".join(map(str, hex2bit(p))),
        2: lambda p: "".join(map(str, ascii2bit(p))),
    }

    def align_messages(self, pattern: str, view_type: int, use_decoded=True):
        try:
            bit_pattern = self._PATTERN_TO_BITS[view_type](pattern)
        except KeyError:
            raise ValueError(f"unknown view type {view_type}")

        attr = "decoded_bits_str" if use_decoded else "plain_bits_str"
        hits = [getattr(msg, attr).find(bit_pattern) for msg in self.messages]
        rightmost = max(hits, default=0)
        for msg, hit in zip(self.messages, hits):
            msg.alignment_offset = rightmost - hit if hit != -1 else 0

    # -- frequency estimation ---------------------------------------------
    def estimate_frequency_for_one(self, sample_rate: float, nbits=42) -> float:
        return self._estimate_frequency_for_bit(True, sample_rate, nbits)

    def estimate_frequency_for_zero(self, sample_rate: float, nbits=42) -> float:
        return self._estimate_frequency_for_bit(False, sample_rate, nbits)

    def _estimate_frequency_for_bit(self, bit: bool, sample_rate: float,
                                    nbits: int) -> float:
        if nbits == 0:
            return 0
        assert self.signal is not None

        def frequencies():
            for i, message in enumerate(self.messages):
                for j, msg_bit in enumerate(message.plain_bits):
                    if msg_bit == bit:
                        start, n = self.get_samplepos_of_bitseq(i, j, i, j + 1,
                                                                False)
                        yield self.signal.estimate_frequency(start, start + n,
                                                             sample_rate)

        from itertools import islice

        sample = list(islice(frequencies(), nbits))
        return np.mean(sample) if sample else 0

    def __str__(self):
        return "ProtoAnalyzer " + self.name

    # -- message types -----------------------------------------------------
    def add_new_message_type(self, labels):
        names = set(mt.name for mt in self.message_types)
        i = 0
        while True:
            i += 1
            name = "Message type #" + str(i)
            if name not in names:
                self.message_types.append(
                    MessageType(name=name, iterable=[copy.deepcopy(lbl) for lbl in labels])
                )
                break

    def update_auto_message_types(self):
        for message in self.messages:
            for message_type in filter(
                lambda m: m.assigned_by_ruleset and len(m.ruleset) > 0, self.message_types
            ):
                if message_type.ruleset.applies_for_message(message):
                    message.message_type = message_type
                    break

    def auto_assign_labels(self, device=None):
        """Infer message types and labels with awre's FormatFinder, on
        ``device`` when given, else on the signal's device when there is a
        signal (placed when it was made with device="auto"), else on the
        default (the CUDA card)."""
        from urh_tpu_torch.awre.format_finder import FormatFinder

        if device is None and self.signal is not None:
            device = self.signal.requested_device
        format_finder = FormatFinder(self.messages, device=device)
        format_finder.run(max_iterations=10)
        self.message_types[:] = format_finder.message_types
        for msg_type, indices in format_finder.existing_message_types.items():
            for i in indices:
                self.messages[i].message_type = msg_type

    def eliminate(self):
        self.message_types = None
        self.messages = None
        self.signal = None

    # -- persistence -------------------------------------------------------
    def to_binary(self, filename: str, use_decoded: bool):
        with open(filename, "wb") as f:
            for msg in self.messages:
                bits = msg.decoded_bits if use_decoded else msg.plain_bits
                f.write(bytes(aggregate_bits(bits, size=8)))

    def from_binary(self, filename: str):
        aggregated = np.fromfile(filename, dtype=np.uint8)
        unaggregated = [int(b) for n in aggregated for b in "{0:08b}".format(n)]
        self.messages.append(Message(unaggregated, 0, self.default_message_type))

    def to_xml_tag(self, decodings, participants, tag_name="protocol",
                   include_message_type=False, write_bits=False, messages=None,
                   modulators=None) -> ET.Element:
        root = ET.Element(tag_name)

        if modulators is not None:
            from urh_tpu_torch.dsp.modulator import Modulator

            root.append(Modulator.modulators_to_xml_tag(modulators))
        root.append(Encoding.decodings_to_xml_tag(decodings))
        root.append(Participant.participants_to_xml_tag(participants))

        ET.SubElement(root, "messages").extend(
            message.to_xml(decoders=decodings,
                           include_message_type=include_message_type,
                           write_bits=write_bits)
            for message in (self.messages if messages is None else messages))

        if not include_message_type:
            ET.SubElement(root, "message_types").extend(
                mt.to_xml() for mt in self.message_types)
        return root

    def to_xml_file(self, filename: str, decoders, participants, tag_name="protocol",
                    include_message_types=False, write_bits=False, modulators=None):
        tag = self.to_xml_tag(decodings=decoders, participants=participants,
                              tag_name=tag_name, include_message_type=include_message_types,
                              write_bits=write_bits, modulators=modulators)
        xmlstr = minidom.parseString(ET.tostring(tag)).toprettyxml(indent="   ")
        with open(filename, "w") as f:
            for line in xmlstr.split("\n"):
                if line.strip():
                    f.write(line + "\n")

    def from_xml_tag(self, root: ET.Element, read_bits=False, participants=None,
                     decodings=None):
        if root is None or len(root) == 0:
            return None

        decoders = (Encoding.read_decoders_from_xml_tag(root)
                    if decodings is None else decodings)
        if participants is None:
            participants = Participant.read_participants_from_xml_tag(root)

        types_tag = root.find("message_types")
        new_types = (MessageType.from_xml(tag)
                     for tag in (types_tag.findall("message_type")
                                 if types_tag is not None else ()))
        self.message_types.extend(
            mt for mt in new_types if mt not in self.message_types)

        messages_tag = root.find("messages")
        message_tags = (messages_tag.findall("message")
                        if messages_tag is not None else [])
        if read_bits:
            self.messages[:] = [
                Message.new_from_xml(tag=tag, participants=participants,
                                     decoders=decoders,
                                     message_types=self.message_types)
                for tag in message_tags]
        else:
            for message, tag in zip(self.messages, message_tags):
                message.from_xml(tag=tag, participants=participants,
                                 decoders=decoders,
                                 message_types=self.message_types)

    def from_xml_file(self, filename: str, read_bits=False):
        try:
            tree = ET.parse(filename)
        except (FileNotFoundError, ET.ParseError):
            return
        self.from_xml_tag(tree.getroot(), read_bits=read_bits)

    def to_pcapng(self, filename: str, hardware_desc_name: str = "", link_type: int = 147):
        from urh_tpu_torch.dev import pcapng

        pcapng.create_pcapng_file(filename=filename, shb_userappl="urh_tpu_torch",
                                  shb_hardware=hardware_desc_name, link_type=link_type)
        pcapng.append_packets_to_pcapng(
            filename=filename,
            packets=(msg.decoded_ascii_buffer for msg in self.messages),
            timestamps=(msg.timestamp for msg in self.messages),
        )

    # -- string parsing (ProtocolAnalyzer.py:842-898) ----------------------
    @staticmethod
    def get_protocol_from_string(message_strings: list, is_hex=None, default_pause=0,
                                 sample_rate=1e6) -> "ProtocolAnalyzer":
        protocol = ProtocolAnalyzer(None)
        # unit suffix -> samples-per-unit factor ("" = raw sample count);
        # ordered longest-first so "ms" wins over "s"
        units = (("ms", sample_rate / 1e3), ("µs", sample_rate / 1e6),
                 ("us", sample_rate / 1e6), ("ns", sample_rate / 1e9),
                 ("s", sample_rate), ("", 1.0))

        def parse_line(line: str):
            # support transcript files, e.g. "1 (A->B): 10101111"
            line = line[line.rfind(" ") + 1:]
            # support pauses like 100101/10s
            data, _, pause = line.partition(PAUSE_SEP)
            if not pause:
                pause = str(default_pause)
            suffix, factor = next((u, f) for u, f in units
                                  if pause.endswith(u))
            return data, int(float(pause[:len(pause) - len(suffix)]) * float(factor))

        if not is_hex:
            for line in filter(None, map(str.strip, message_strings)):
                bits, pause = parse_line(line)
                try:
                    protocol.messages.append(Message.from_plain_bits_str(bits, pause=pause))
                except ValueError:
                    is_hex = True if is_hex is None else is_hex
                    break

        if is_hex:
            protocol.messages.clear()
            lookup = {"{0:0x}".format(i): "{0:04b}".format(i) for i in range(16)}
            for line in filter(None, map(str.strip, message_strings)):
                bits, pause = parse_line(line)
                bit_str = [lookup[bits[i].lower()] for i in range(len(bits))]
                protocol.messages.append(
                    Message.from_plain_bits_str("".join(bit_str), pause=pause)
                )
        return protocol


def demodulate(signal, params=None, device=None) -> list:
    """One-call demodulation: Signal (or IQ array) -> list of Messages.

    A Signal is demodulated on its own device; an IQ array on ``device``
    (default: the CUDA card, RuntimeError without one; ``"auto"`` makes a
    signal that places the calls urh_tpu places)."""
    from urh_tpu_torch.core.signal import Signal
    from urh_tpu_torch.util import placement

    if not isinstance(signal, Signal):
        signal = Signal.from_iq(signal, device=device)
    elif device is not None and placement.place(device)[0] != signal.device:
        raise ValueError(f"signal lives on {signal.device}, not {device}")
    if params is not None:
        signal.params = params
        signal._qad = None
    analyzer = ProtocolAnalyzer(signal)
    analyzer.get_protocol_from_signal()
    return analyzer.messages
