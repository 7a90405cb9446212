"""Share of the traced window in which nothing ran on the card, in %: 100
minus the union of kernel, copy and set time over the window's length."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
