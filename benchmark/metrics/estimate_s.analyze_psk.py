"""Seconds an analysis spends in ``Signal.auto_detect`` at the modulation
set (the estimation layer, one B5 launch), the mean over the benchmark's
``bench.estimate`` spans in the trace."""


def read(ctx):
    spans = ctx.trace.named("bench.estimate")
    return sum(b - a for a, b in spans) * 1e-6 / len(spans) if spans else None
