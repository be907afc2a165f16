"""Share of the traced window in which the card ran no kernel and no copy,
in %."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
