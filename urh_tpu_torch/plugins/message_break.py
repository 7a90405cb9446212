"""MessageBreak: split one message into two at a bit position.

Counterpart of urh/plugins/MessageBreak. Unlike the reference action
(MessageBreakAction.py), undo is surgical: only the affected message is
kept aside and spliced back, instead of deep-copying the whole message
list on every break.
"""

from __future__ import annotations

from urh_tpu_torch.plugins.manager import ProtocolPlugin
from urh_tpu_torch.protocol.message import Message


def split_message(msg: Message, pos: int) -> tuple[Message, Message]:
    """Cut `msg` at plain-bit index `pos`; the pause stays with the tail."""
    shared = dict(rssi=msg.rssi, decoder=msg.decoder,
                  message_type=msg.message_type,
                  samples_per_symbol=msg.samples_per_symbol)
    head = Message(plain_bits=msg.plain_bits[:pos], pause=0, **shared)
    tail = Message(plain_bits=msg.plain_bits[pos:], pause=msg.pause, **shared)
    return head, tail


class MessageBreakAction:
    text = "Break message behind selection"

    def __init__(self, proto_analyzer, msg_nr: int, pos: int):
        self.proto_analyzer = proto_analyzer
        self.msg_nr = msg_nr
        self.pos = pos
        self._broken: Message | None = None  # original, kept for undo

    def redo(self):
        msgs = self.proto_analyzer.messages
        self._broken = msgs[self.msg_nr]
        head, tail = split_message(self._broken, self.pos)
        msgs[self.msg_nr:self.msg_nr + 1] = [head, tail]

    def undo(self):
        if self._broken is None:
            return
        msgs = self.proto_analyzer.messages
        msgs[self.msg_nr:self.msg_nr + 2] = [self._broken]
        self._broken = None


class MessageBreakPlugin(ProtocolPlugin):
    def __init__(self):
        super().__init__(name="MessageBreak")

    def get_action(self, protocol, msg_nr: int, pos: int,
                   view: int = 0) -> MessageBreakAction:
        pos = protocol.convert_index(pos, view, 0, True, message_indx=msg_nr)[0]
        return MessageBreakAction(protocol, msg_nr, pos)
