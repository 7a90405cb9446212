"""Seconds an analysis spends in ``estimate()`` on the capture's magnitudes and
URH's noise floor: the program's ``estimate.noise`` spans in the trace over the
analyses there."""

from benchmark import program_spans


def read(ctx):
    return program_spans.per_analysis_s(ctx.trace, "estimate.noise")
