"""CIGAR runs the device returned a pair, over the traced calls
(``AlignStats.runs``: the run totals of the lanes that did not fail, read
from the meta each tile reads back) divided by the pairs those calls were
given; None where the program has no such counter."""


def read(ctx):
    runs = getattr(ctx.stats, "runs", None)
    return None if runs is None else runs / (ctx.pairs_per_call * ctx.calls)
