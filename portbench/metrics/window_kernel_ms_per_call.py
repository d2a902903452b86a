"""Device time of the window kernels (name holds ``genasm_windows``), ms a
call, from the profiler trace of the traced calls."""


def read(ctx):
    s = ctx.trace.kernel_s("genasm_windows")
    return s * 1e3 / ctx.calls if s > 0 else None
