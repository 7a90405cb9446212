"""ZeroHide: hide long zero sequences in the decoded view
(urh/plugins/ZeroHide counterpart without Qt)."""

from __future__ import annotations


class ZeroHideAction:
    def __init__(self, protocol, following_zeros: int, view: int, zero_hide_offsets: dict):
        self.protocol = protocol
        self.following_zeros = following_zeros
        self.viewtype = view
        self.zero_hide_offsets = zero_hide_offsets
        self.text = "Hide zero sequences >= " + str(following_zeros)

    # bits per character of each decoded view
    _VIEW_FACTORS = {0: 1, 1: 4, 2: 8}
    _VIEW_DATA = {0: "decoded_bits_str", 1: "decoded_hex_str", 2: "decoded_ascii_str"}

    def redo(self):
        factor = self._VIEW_FACTORS.get(self.viewtype, 8)
        self.zero_hide_offsets.clear()
        for i, message in enumerate(self.protocol.messages):
            data = getattr(message, self._VIEW_DATA.get(self.viewtype, "decoded_ascii_str"))
            zero_sequences = self._get_zero_seq_indexes(data, self.following_zeros)
            self.zero_hide_offsets[i] = {start: end - start
                                         for start, end in zero_sequences}
            # cut from the back so earlier offsets stay valid
            for start, end in reversed(zero_sequences):
                bits = message.decoded_bits
                message.decoded_bits = (bits[: start * factor]
                                        + bits[end * factor:])

    def undo(self):
        self.zero_hide_offsets.clear()
        self.protocol.clear_decoded_bits()

    @staticmethod
    def _get_zero_seq_indexes(message: str, following_zeros: int):
        """(start, end) spans of '0'-runs at least following_zeros long."""
        if following_zeros > len(message):
            return []

        result, run = [], 0
        for i, char in enumerate(message):
            if char == "0":
                run += 1
                continue
            if run >= following_zeros:
                result.append((i - run, i))
            run = 0

        if run >= following_zeros:
            result.append((len(message) - run, len(message)))
        return result


from urh_tpu_torch.plugins.manager import ProtocolPlugin


class ZeroHidePlugin(ProtocolPlugin):
    def __init__(self):
        super().__init__(name="ZeroHide")
        from urh_tpu_torch.util import settings

        self.following_zeros = settings.read("following_zeros", 5, int)
        self.zero_hide_offsets = dict()

    def get_action(self, protocol, view: int) -> ZeroHideAction:
        return ZeroHideAction(protocol, self.following_zeros, view, self.zero_hide_offsets)
