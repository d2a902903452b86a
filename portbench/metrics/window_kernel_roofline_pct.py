"""The window kernels' share of their roofline, %: the least time a call's
work could take on an H100 (``roofline.per_call``: the work counted by the
benchmark's reference on its sample of pairs) over the kernels' device time
a call from the trace."""

from portbench import roofline


def read(ctx):
    s = ctx.trace.kernel_s("genasm_windows")
    if s <= 0:
        return None
    least_ms, _ = roofline.per_call(ctx)
    return 100.0 * least_ms / (s * 1e3 / ctx.calls)
