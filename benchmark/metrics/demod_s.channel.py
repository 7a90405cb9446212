"""Seconds an analysis spends in ``urh_tpu_torch.demodulate`` of the
filtered signal (staging, K1, runs and bits), the mean over the benchmark's
``bench.demodulate`` spans in the trace."""


def read(ctx):
    spans = ctx.trace.named("bench.demodulate")
    return sum(b - a for a, b in spans) * 1e-6 / len(spans) if spans else None
