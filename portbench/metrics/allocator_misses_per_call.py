"""Fresh device segments and pinned host blocks the caching allocators
took during a call, a call (``AlignStats.allocator_misses`` of the traced
calls); None where the run has no card or the program no such counter."""


def read(ctx):
    n = getattr(ctx.stats, "allocator_misses", None)
    if n is None or ctx.trace.busy_s <= 0:
        return None
    return n / ctx.calls
