"""Device seconds an analysis spends in the Costas loop (B5): the kernels
launched inside the program's ``demod.costas`` spans in the trace, over the
analyses (``bench.estimate`` spans) there.  None where the program has no
such span."""


def read(ctx):
    analyses = ctx.trace.named("bench.estimate")
    kernel_s = ctx.trace.kernel_s_launched_in("demod.costas")
    if not analyses or kernel_s <= 0:
        return None
    return kernel_s / len(analyses)
