"""Seconds an analysis spends in ``estimate()`` on the modulation
classification and the OOK merge: the program's ``estimate.classify`` spans in
the trace over the analyses there."""

from benchmark import program_spans


def read(ctx):
    return program_spans.per_analysis_s(ctx.trace, "estimate.classify")
