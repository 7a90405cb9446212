"""Milliseconds a drain's ``StreamDemodulator.feed`` takes in the sniffer,
from the program's own counter (``util.metrics`` stage
``sniffer.demodulate``: host seconds over calls) over the window."""


def read(ctx):
    return ctx.counters.get("feed_ms")
