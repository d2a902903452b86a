"""The least time the window kernels could take on the work a call needs.

A frozen copy of the bound arithmetic of
scrooge_tpu_torch/profiling/model.py at commit 00e5ff3 (``_bound``,
``window_ops``, ``window_bytes`` and the H100 rates), fed with the work
that this benchmark's own reference counts, never with the program's
counters. The rates are the published ones of an H100 SXM at its full
700 W: HBM3 at 3.35 TB/s, and 132 SMs x 64 INT32 lanes x 1,980 MHz.

Operations: a DP cell is ``(shl1(right) | pm) & shl1(topright) &
shl1(top) & topright`` on NW 64-bit words, which takes 8 INT32
instructions a word (two three-input logic ops and two funnel shifts a
32-bit half); a traceback step takes 12 (three bit tests and the moves).
Bytes: every packed text and pattern character read once, 16 bytes of
lengths and bases and 24 of results a pair, two bytes a CIGAR run and four
a window's run count written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1980e6
CELL_OPS_PER_WORD = 8
TB_STEP_OPS = 12


def window_ops(W: int, cells: float, steps: float) -> float:
    nw = -(-W // 64)
    return cells * CELL_OPS_PER_WORD * nw + steps * TB_STEP_OPS


def window_bytes(pairs: float, read_chars: float, runs: float,
                 windows: float) -> float:
    # about as many text characters are consumed as read characters
    return 2 * read_chars / 4 + 16 * pairs + 2 * runs + 4 * windows \
        + 24 * pairs


def least_ms(W: int, cells: float, steps: float, pairs: float,
             read_chars: float, runs: float, windows: float):
    """(least ms, "operations" or "bytes", whichever bounds it)."""
    t_ops = window_ops(W, cells, steps) / INT32_OPS_PER_S * 1e3
    t_bytes = window_bytes(pairs, read_chars, runs, windows) \
        / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def per_call(ctx):
    """least_ms of one call of the run described by ``ctx``: its window
    width ``ctx.W``, pairs a call ``ctx.pairs_per_call``, and the work a
    pair takes on average in the reference's sample (``ctx.work``: cells,
    steps, runs, windows and read characters a pair)."""
    p, w = ctx.pairs_per_call, ctx.work
    return least_ms(ctx.W, w["cells"] * p, w["steps"] * p, p,
                    w["read_chars"] * p, w["runs"] * p, w["windows"] * p)
