"""Seconds an analysis spends in ``estimate()`` on the per-message scans and
the vote: the program's ``estimate.scan`` spans in the trace over the analyses
there."""

from benchmark import program_spans


def read(ctx):
    return program_spans.per_analysis_s(ctx.trace, "estimate.scan")
