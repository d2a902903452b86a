"""A call's head (entry to its first launch's return) and tail (its last
meta sync's return to its exit), in which no kernel of the call is in
flight, ms a call (``AlignStats.edges_ns`` of the traced calls); None
where the program has no such field."""


def read(ctx):
    ns = getattr(ctx.stats, "edges_ns", None)
    return None if ns is None else ns / 1e6 / ctx.calls
