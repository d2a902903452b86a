"""CIGAR strings decoded from the read-back runs on the host, ms a call
(``AlignStats.format_ns`` of the traced calls; it overlaps other stages)."""


def read(ctx):
    return ctx.stats.format_ns / 1e6 / ctx.calls
