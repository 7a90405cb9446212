"""Seconds an analysis spends in ``Signal.bandpass`` (the capture to
complex64, the filter, the new signal): the program's ``filter.bandpass``
spans in the trace over the analyses there.  None where the program has no
such span."""

from benchmark import program_spans


def read(ctx):
    return program_spans.per_analysis_s(ctx.trace, "filter.bandpass")
