"""Bytes read back from the card a CIGAR run (``AlignStats.readback_bytes``
over ``AlignStats.runs`` of the traced calls): a readback chunk is read at
the width of its largest lane, so the bytes above a run's own entry are
the padding of that layout; None where the program has no run counter."""


def read(ctx):
    runs = getattr(ctx.stats, "runs", None)
    return None if not runs else ctx.stats.readback_bytes / runs
