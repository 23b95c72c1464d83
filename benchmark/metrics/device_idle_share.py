"""Share of the traced part of the window in which no device activity
ran (%)."""


def read(ctx):
    if ctx.traced_s <= 0 or not ctx.kernels:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.traced_s)
