"""Milliseconds from the start of the drain that fed a message's last
sample to its ``message_sniffed``, the 95th percentile: the program's
``sniffer.emit_wait`` spans in its timeline, over the window and the
sender's tail."""

from benchmark import program_spans


def read(ctx):
    return program_spans.length_p95_ms("sniffer.emit_wait")
