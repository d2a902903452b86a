"""Host validation, encoding and 2-bit packing of the reads, ms a call
(``AlignStats.prep_ns`` of the traced calls; it overlaps other stages)."""


def read(ctx):
    return ctx.stats.prep_ns / 1e6 / ctx.calls
