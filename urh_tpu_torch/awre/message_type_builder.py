"""MessageType construction from inferred fields
(urh/awre/MessageTypeBuilder.py)."""

from __future__ import annotations

from urh_tpu_torch.protocol.labels import ChecksumLabel, FieldType, MessageType, ProtocolLabel


class MessageTypeBuilder:
    def __init__(self, name: str):
        self.name = name
        self.message_type = MessageType(name)

    def _next_slot(self):
        """(start, color_index) continuing after the last appended label."""
        if len(self.message_type) == 0:
            return 0, 0
        last = self.message_type[-1]
        return last.end, last.color_index + 1

    def add_label(self, label_type: FieldType.Function, length: int, name: str = None):
        start, color_index = self._next_slot()
        lbl = ProtocolLabel(name if name is not None else label_type.value,
                            start, start + length - 1, color_index,
                            field_type=FieldType(label_type.name, label_type))
        self.message_type.append(lbl)

    def _default_data_start(self):
        """Checksummed data begins after sync, else after preamble, else 0."""
        for function in (FieldType.Function.SYNC, FieldType.Function.PREAMBLE):
            anchor = self.message_type.get_first_label_with_type(function)
            if anchor:
                return anchor.end
        return 0

    def add_checksum_label(self, length, checksum, data_start=None, data_end=None,
                           name: str = None):
        function = FieldType.Function.CHECKSUM
        start, color_index = self._next_slot()

        lbl = ChecksumLabel(name if name is not None else function.value,
                            start, start + length - 1, color_index,
                            field_type=FieldType(function.name, function))
        lbl.data_ranges = [(self._default_data_start() if data_start is None
                            else data_start,
                            start if data_end is None else data_end)]
        lbl.checksum = checksum
        self.message_type.append(lbl)
