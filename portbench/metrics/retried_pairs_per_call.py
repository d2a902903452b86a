"""Pairs whose device alignment failed and were redone on the host's
scalar oracle, a call (``AlignStats.retried_pairs`` of the traced calls)."""


def read(ctx):
    return ctx.stats.retried_pairs / ctx.calls
