"""Per-pair Python of a call, ms a call: the pair list, lengths and sort,
each tile's per-lane results, and the output's assembly
(``AlignStats.pair_python_ns`` of the traced calls, the ``scrooge.pairs``,
``scrooge.results`` and ``scrooge.finish`` spans); None where the program
has no such field."""


def read(ctx):
    ns = getattr(ctx.stats, "pair_python_ns", None)
    return None if ns is None else ns / 1e6 / ctx.calls
