"""Host time dispatching tiles to the card, ms a call: the scratch budget
(cudaMemGetInfo), the pinned staging and copy enqueue of the uploads, and
the engine's output and scratch allocation and kernel launches
(``AlignStats.dispatch_ns`` of the traced calls, the ``scrooge.budget``,
``scrooge.upload`` and ``scrooge.launch`` spans); None where the program
has no such field."""


def read(ctx):
    ns = getattr(ctx.stats, "dispatch_ns", None)
    return None if ns is None else ns / 1e6 / ctx.calls
