"""Share of its least time the band-pass filter's device work reaches, in
%: the least time of the filters in the trace (``benchmark/
bandpass_yardstick.py``: each capture sample read once, the filtered float32
planes written once, at the card's peak bandwidth) over the device time of
the kernels launched inside the program's ``filter.bandpass`` spans.  None
where the program has no such span or launched nothing in it."""

from benchmark import bandpass_yardstick


def read(ctx):
    spans = ctx.trace.named("filter.bandpass")
    kernel_s = ctx.trace.kernel_s_launched_in("filter.bandpass")
    if not spans or kernel_s <= 0:
        return None
    c = ctx.counters
    least = len(spans) * bandpass_yardstick.least_seconds(c["capture_samples"],
                                                          c["sample_itemsize"])
    return 100.0 * least / kernel_s
