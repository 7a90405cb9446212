"""Undoable editing actions for signals and protocol tables (PyTorch port
of urh_tpu.ui.actions).

Headless re-design of the reference's ui/actions/ package
(EditSignalAction.py, ChangeSignalParameter.py, DeleteBitsAndPauses.py,
InsertBitsAndPauses.py, Fuzz.py, InsertColumn.py, Clear.py).  Unlike the
reference, the demodulated (qad) cache is not snapshotted per action: the
demodulation runs on the signal's device (one fused kernel launch for
ASK and FSK on the card), so undo drops the cache, and the fused kernels'
states with it, and the next access recomputes both there.  What an
action keeps for its undo is host data: samples as NumPy arrays, messages
as bits.
"""

from __future__ import annotations

import copy
from enum import Enum

import numpy as np

from urh_tpu_torch.ui.undo import UndoCommand
from urh_tpu_torch.util import settings


class EditAction(Enum):
    crop = 1
    mute = 2
    delete = 3
    paste = 4
    insert = 5
    filter = 6


def find_message_indices_in_sample_range(messages, start: int, end: int):
    """Indices of messages fully contained in [start, end)
    (EditSignalAction.py:203-211)."""
    result = []
    for i, message in enumerate(messages):
        if len(message.bit_sample_pos) < 2:
            continue
        if message.bit_sample_pos[0] >= start and message.bit_sample_pos[-2] <= end:
            result.append(i)
        elif message.bit_sample_pos[-2] > end:
            break
    return result


class EditSignalAction(UndoCommand):
    """Crop/mute/delete/paste/insert/filter a sample range of a Signal with
    full undo, preserving per-message metadata (decoder/participant/
    message_type) across the resulting re-demodulation
    (EditSignalAction.py:25-236)."""

    def __init__(self, signal, mode: EditAction, start: int = 0, end: int = 0,
                 position: int = 0, data_to_insert: np.ndarray = None,
                 dsp_filter=None, protocol=None):
        super().__init__()
        self.signal = signal
        self.mode = mode
        self.start = int(start)
        self.end = int(end)
        self.position = int(position)
        self.data_to_insert = data_to_insert
        self.dsp_filter = dsp_filter
        self.protocol = protocol

        if mode == EditAction.crop:
            self.set_text("Crop Signal")
            self.pre_crop_data = np.copy(signal.iq_array[0:self.start])
            self.post_crop_data = np.copy(signal.iq_array[self.end:])
        elif mode in (EditAction.mute, EditAction.filter):
            self.set_text("Mute Signal" if mode == EditAction.mute else "Filter Signal")
            self.orig_data_part = np.copy(signal.iq_array[self.start:self.end])
        elif mode == EditAction.delete:
            self.set_text("Delete Range")
            self.orig_data_part = np.copy(signal.iq_array[self.start:self.end])
        elif mode == EditAction.paste:
            self.set_text("Paste")
        elif mode == EditAction.insert:
            self.set_text("Insert")

        self.orig_parameter_cache = copy.deepcopy(signal.parameter_cache)
        if self.protocol is not None:
            self.orig_messages = copy.copy(self.protocol.messages)

    # -- helpers -----------------------------------------------------------
    def _keep_indices_for_edit(self):
        msgs = self.orig_messages
        if self.mode in (EditAction.delete, EditAction.mute):
            removed = find_message_indices_in_sample_range(msgs, self.start, self.end)
            if not removed:
                return {i: i for i in range(len(msgs))}
            keep = {}
            for i in range(len(msgs)):
                if i < removed[0]:
                    keep[i] = i
                elif i > removed[-1]:
                    keep[i] = i - len(removed)
            return keep
        if self.mode == EditAction.crop:
            removed_left = find_message_indices_in_sample_range(msgs, 0, self.start)
            removed_right = find_message_indices_in_sample_range(
                msgs, self.end, self.signal.num_samples)
            last_left = removed_left[-1] if removed_left else -1
            first_right = removed_right[0] if removed_right else len(msgs) + 1
            return {i: i - len(removed_left) for i in range(len(msgs))
                    if last_left < i < first_right}
        if self.mode in (EditAction.paste, EditAction.insert):
            keep = {i: i for i in range(len(msgs))}
            inside = find_message_indices_in_sample_range(
                msgs, self.position, self.position + len(self.data_to_insert))
            n = len(inside)
            if n:
                for i in inside:
                    del keep[i]
                for i in range(inside[-1] + 1, len(msgs)):
                    keep[i - n] = i
            return keep
        return {i: i for i in range(len(msgs))}

    def redo(self):
        keep = self._keep_indices_for_edit() if self.protocol is not None else {}

        if self.mode == EditAction.delete:
            self.signal.delete_range(self.start, self.end)
        elif self.mode == EditAction.mute:
            self.signal.mute_range(self.start, self.end)
        elif self.mode == EditAction.crop:
            self.signal.crop_to_range(self.start, self.end)
        elif self.mode in (EditAction.paste, EditAction.insert):
            self.signal.insert_data(self.position, self.data_to_insert)
        elif self.mode == EditAction.filter:
            self.signal.filter_range(self.start, self.end, self.dsp_filter)

        if self.protocol is not None:
            # re-demodulate, then restore per-message metadata for survivors
            self.protocol.get_protocol_from_signal()
            for old_index, new_index in keep.items():
                try:
                    old_msg = self.orig_messages[old_index]
                    new_msg = self.protocol.messages[new_index]
                    new_msg.decoder = old_msg.decoder
                    new_msg.message_type = old_msg.message_type
                    new_msg.participant = old_msg.participant
                except IndexError:
                    continue

    def undo(self):
        from urh_tpu_torch.core.iq import IQData

        if self.mode == EditAction.delete:
            self.signal.iq_array.insert_subarray(self.start, self.orig_data_part)
            self.signal._qad = None
        elif self.mode in (EditAction.mute, EditAction.filter):
            self.signal.iq_array[self.start:self.end] = self.orig_data_part
            self.signal._qad = None
        elif self.mode == EditAction.crop:
            self.signal.iq_array = IQData(
                np.concatenate((self.pre_crop_data, self.signal.iq_array.data,
                                self.post_crop_data)), skip_conversion=True)
            self.signal._qad = None
        elif self.mode in (EditAction.paste, EditAction.insert):
            self.signal.delete_range(self.position,
                                     self.position + len(self.data_to_insert))

        self.signal.parameter_cache = self.orig_parameter_cache
        if self.protocol is not None:
            self.protocol.messages = self.orig_messages


class ChangeSignalParameter(UndoCommand):
    """Set a demod parameter on a Signal; undo restores the parameter AND the
    previously demodulated messages (ChangeSignalParameter.py:10-72)."""

    def __init__(self, signal, protocol, parameter_name: str, parameter_value):
        super().__init__()
        if not hasattr(signal, parameter_name):
            raise ValueError(f"signal has no attribute {parameter_name}")
        self.signal = signal
        self.protocol = protocol
        self.parameter_name = parameter_name
        self.parameter_value = parameter_value
        self.orig_value = getattr(signal, parameter_name)
        name = signal.name[:10] + "..." if len(signal.name) > 10 else signal.name
        self.set_text(f"change {parameter_name} of {name} "
                      f"from {self.orig_value} to {parameter_value}")
        self.orig_messages = copy.deepcopy(protocol.messages) if protocol else []

    def redo(self):
        msg_data = [(m.decoder, m.participant, m.message_type)
                    for m in (self.protocol.messages if self.protocol else [])]
        setattr(self.signal, self.parameter_name, self.parameter_value)
        if self.protocol is not None:
            self.protocol.get_protocol_from_signal()
            if len(msg_data) == self.protocol.num_messages:
                for msg, (dec, part, mtype) in zip(self.protocol.messages, msg_data):
                    msg.decoder = dec
                    msg.participant = part
                    msg.message_type = mtype

    def undo(self):
        setattr(self.signal, self.parameter_name, self.orig_value)
        if self.protocol is not None:
            self.protocol.messages = self.orig_messages


class DeleteBitsAndPauses(UndoCommand):
    """Delete a bit/hex/ascii range from a span of messages in an analyzer
    (DeleteBitsAndPauses.py:9-76)."""

    def __init__(self, proto_analyzer, start_message: int, end_message: int,
                 start: int, end: int, view: int, decoded: bool,
                 subprotos=None, update_label_ranges=True):
        super().__init__("Delete")
        self.proto_analyzer = proto_analyzer
        self.start_message = start_message
        self.end_message = end_message
        self.start = start
        self.end = end
        self.view = view
        self.decoded = decoded
        self.update_label_ranges = update_label_ranges
        self.sub_protocols = subprotos or []
        self.sub_protocol_history = {p: p.messages for p in self.sub_protocols}
        self.saved_messages = []
        self.removed_message_indices = []

    def redo(self):
        self.saved_messages = copy.deepcopy(
            self.proto_analyzer.messages[self.start_message:self.end_message + 1])
        self.removed_message_indices = self.proto_analyzer.delete_messages(
            self.start_message, self.end_message, self.start, self.end,
            self.view, self.decoded, self.update_label_ranges)

    def undo(self):
        for i in reversed(range(self.start_message, self.end_message + 1)):
            saved = self.saved_messages[i - self.start_message]
            if i in self.removed_message_indices:
                self.proto_analyzer.messages.insert(i, saved)
            else:
                try:
                    self.proto_analyzer.messages[i] = saved
                except IndexError:
                    self.proto_analyzer.messages.append(saved)
        for sub_protocol, messages in self.sub_protocol_history.items():
            sub_protocol.messages = messages
        self.saved_messages = []
        self.removed_message_indices = []


class InsertBitsAndPauses(UndoCommand):
    """Insert all messages of an analyzer into a generator container at an
    index (InsertBitsAndPauses.py:8-33)."""

    def __init__(self, container, index: int, proto_analyzer):
        super().__init__()
        self.container = container
        self.proto_analyzer = proto_analyzer
        self.index = index
        if self.index == -1 or self.index > len(container.messages):
            self.index = len(container.messages)
        self.set_text(f"Insert data at index {self.index:d}")
        self.num_messages = 0

    def redo(self):
        self.container.insert_protocol_analyzer(self.index, self.proto_analyzer)
        self.num_messages += len(self.proto_analyzer.messages)

    def undo(self):
        for i in reversed(range(self.index, self.index + self.num_messages)):
            del self.container.messages[i]
        self.num_messages = 0


class Fuzz(UndoCommand):
    """Run successive/concurrent/exhaustive fuzzing on the generator container;
    undo removes the generated messages (Fuzz.py:7-44)."""

    def __init__(self, container, fuzz_mode: str):
        super().__init__(f"{fuzz_mode} Fuzzing")
        self.container = container
        self.fuzz_mode = fuzz_mode
        self.added_message_indices = []

    def redo(self):
        if settings.read("use_default_fuzzing_pause", True, bool):
            default_pause = settings.read("default_fuzzing_pause", 10**6, int)
        else:
            default_pause = None
        fn = {"successive": self.container.fuzz_successive,
              "concurrent": self.container.fuzz_concurrent,
              "exhaustive": self.container.fuzz_exhaustive}.get(
                  str(self.fuzz_mode).lower())
        if fn is None:
            raise ValueError(f"unknown fuzzing mode {self.fuzz_mode!r}")
        self.added_message_indices.extend(fn(default_pause=default_pause))

    def undo(self):
        for index in reversed(self.added_message_indices):
            del self.container.messages[index]
        self.added_message_indices.clear()


class InsertColumn(UndoCommand):
    """Insert a zero column (1 bit / 4 bits / 8 bits depending on view) into
    selected rows (InsertColumn.py:9-34)."""

    def __init__(self, proto_analyzer, index: int, rows: list, view: int):
        super().__init__(f"Insert column at {index:d}")
        self.proto_analyzer = proto_analyzer
        self.index = proto_analyzer.convert_index(
            index, from_view=view, to_view=0, decoded=False)[0]
        self.nbits = 1 if view == 0 else 4 if view == 1 else 8
        self.rows = rows
        self.saved_messages = {}

    def redo(self):
        for i in self.rows:
            msg = self.proto_analyzer.messages[i]
            self.saved_messages[i] = copy.deepcopy(msg)
            for j in range(self.nbits):
                msg.insert(int(self.index) + j, False)

    def undo(self):
        for i in self.rows:
            self.proto_analyzer.messages[i] = self.saved_messages[i]
        self.saved_messages.clear()


class Clear(UndoCommand):
    """Clear the generator table (Clear.py:8-20)."""

    def __init__(self, container):
        super().__init__("Clear Generator Table")
        self.container = container
        self.orig_messages = copy.deepcopy(container.messages)

    def redo(self):
        self.container.clear()

    def undo(self):
        self.container.messages = self.orig_messages
