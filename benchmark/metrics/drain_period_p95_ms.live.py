"""Milliseconds between the starts of consecutive drains of the sniffer's
ring, the 95th percentile: the program's ``sniffer.drain`` spans (drains
that fed samples) in its timeline, over the window and the sender's tail."""

from benchmark import program_spans


def read(ctx):
    spans = program_spans.timeline("sniffer.drain")
    if spans is None or len(spans) < 2:
        return None
    return program_spans.p95_ms([b[0] - a[0] for a, b in zip(spans, spans[1:])])
