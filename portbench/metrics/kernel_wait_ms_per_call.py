"""Host time the tile pipeline's worker spends blocked in each tile's
meta sync, waiting on the card, ms a call (``AlignStats.kernel_wait_ns``
of the traced calls, the ``scrooge.kernel_wait`` span); None where the
program has no such field."""


def read(ctx):
    ns = getattr(ctx.stats, "kernel_wait_ns", None)
    return None if ns is None else ns / 1e6 / ctx.calls
