"""Seconds an analysis spends in ``estimate()`` on the placement and the
capture's upload to the card: the program's ``estimate.stage`` spans in the
trace over the analyses there."""

from benchmark import program_spans


def read(ctx):
    return program_spans.per_analysis_s(ctx.trace, "estimate.stage")
