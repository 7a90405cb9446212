"""Seconds an analysis spends in ``estimate()`` on afp_demod and the
rectangular signal's copy back to the host: the program's ``estimate.rect``
spans in the trace over the analyses there."""

from benchmark import program_spans


def read(ctx):
    return program_spans.per_analysis_s(ctx.trace, "estimate.rect")
