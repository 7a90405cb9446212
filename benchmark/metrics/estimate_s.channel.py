"""Seconds an analysis spends in ``Signal.auto_detect`` of the filtered
signal at the modulation set (the estimation layer), the mean over the
benchmark's ``bench.estimate`` spans in the trace."""


def read(ctx):
    spans = ctx.trace.named("bench.estimate")
    return sum(b - a for a, b in spans) * 1e-6 / len(spans) if spans else None
