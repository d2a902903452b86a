"""Device busy time other than the window kernels (compaction, tokens,
copies, memsets), ms a call: the union of device activity over the traced
calls less the window kernels' time."""


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    rest = ctx.trace.busy_s - ctx.trace.kernel_s("genasm_windows")
    return rest * 1e3 / ctx.calls
