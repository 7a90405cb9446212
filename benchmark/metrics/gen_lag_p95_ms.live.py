"""How late the load generator began its sends, in ms: the 95th percentile
over every block due in the window.  It should stay flat; if it moves, the
yardstick and not the program moved."""


def read(ctx):
    return ctx.counters.get("gen_lag_p95_ms")
