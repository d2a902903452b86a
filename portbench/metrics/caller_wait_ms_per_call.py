"""Host time the caller spends blocked on the tile pipeline's worker, ms
a call (``AlignStats.caller_wait_ns`` of the traced calls, the
``scrooge.caller_wait`` span); None where the program has no such
field."""


def read(ctx):
    ns = getattr(ctx.stats, "caller_wait_ns", None)
    return None if ns is None else ns / 1e6 / ctx.calls
