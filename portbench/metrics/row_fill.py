"""How much of the one-word window kernel's passes the windows needed:
the rows up to each window's first hit over the rows the kernel's passes
of rows spanned (``AlignStats.row_work`` over ``AlignStats.row_slots`` of
the traced calls). None where the program has no such counters, or no
tile ran the one-word kernel."""


def read(ctx):
    slots = getattr(ctx.stats, "row_slots", None)
    return None if not slots else ctx.stats.row_work / slots
