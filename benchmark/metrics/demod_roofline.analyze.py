"""Share of its roofline the offline demodulation's device work reaches, in
%: the least time (each capture byte read once and one state byte a sample
written once, at the card's peak bandwidth) over the device time of every
kernel launched inside the ``bench.demodulate`` spans, whatever its name."""

from benchmark import yardstick


def read(ctx):
    spans = ctx.trace.named("bench.demodulate")
    kernel_s = ctx.trace.kernel_s_launched_in("bench.demodulate")
    if not spans or kernel_s <= 0:
        return None
    c = ctx.counters
    least = yardstick.least_seconds(
        len(spans) * yardstick.demod_least_bytes(c["capture_samples"], c["sample_itemsize"]))
    return 100.0 * least / kernel_s
