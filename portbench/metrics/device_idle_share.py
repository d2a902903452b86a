"""Share of the traced window in which no operation ran on the device:
1 - (union of device activity) / (traced window)."""


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    return 1.0 - ctx.trace.busy_s / ctx.trace.window_s
