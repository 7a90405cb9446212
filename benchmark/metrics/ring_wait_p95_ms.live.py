"""Milliseconds a sample waits in the sniffer's ring before a drain takes
it, the 95th percentile: the program's ``sniffer.ring_wait`` spans (from
the first write after a drain read the write index to the next drain's
start) in its timeline, over the window and the sender's tail."""

from benchmark import program_spans


def read(ctx):
    return program_spans.length_p95_ms("sniffer.ring_wait")
