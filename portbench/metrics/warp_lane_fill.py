"""How full the warps of a thread-a-pair window kernel were: the lanes'
work over the work of their warps at their slowest lane's pace
(``AlignStats.lane_work`` over ``AlignStats.warp_work`` of the traced
calls; a lane's work is its edit distance plus its windows, a proxy for
the early-termination rows it filled). None where the program has no such
counters, or no tile ran a thread-a-pair kernel."""


def read(ctx):
    warp = getattr(ctx.stats, "warp_work", None)
    return None if not warp else ctx.stats.lane_work / warp
