"""Seconds an analysis spends in ``estimate()`` on the segmentation into
messages: the program's ``estimate.segment`` spans in the trace over the
analyses there."""

from benchmark import program_spans


def read(ctx):
    return program_spans.per_analysis_s(ctx.trace, "estimate.segment")
