"""Share of its least time the Costas loop (B5) reaches, in %: the chain's
least time (``benchmark/chain_yardstick.py``) of the traced analyses' steps
(the cell's ``costas_steps``, ``drivers/analyze_psk.py``: each ungated
sample once a launch) over the device time of the kernels launched in the
program's ``demod.costas`` spans, one a launch over all samples of a
capture but its first.  None where the program has no such span."""

from benchmark import chain_yardstick


def read(ctx):
    spans = ctx.trace.named("demod.costas")
    kernel_s = ctx.trace.kernel_s_launched_in("demod.costas")
    if not spans or kernel_s <= 0:
        return None
    c = ctx.counters
    least = chain_yardstick.costas_least_seconds(
        c["costas_steps"], len(spans) * (c["capture_samples"] - 1))
    return 100.0 * least / kernel_s
