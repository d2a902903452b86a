"""Plain NumPy reference of Scrooge's windowed GenASM alignment.

Written from Scrooge's genasm_cpu.cpp (the DP fill :210-288, the traceback
:290-409, the window loop :411-438), as a frozen yardstick of its own: it
imports nothing of the package under test and takes only the inputs the
benchmark made.

GenASM's bitvector R[d][i] has a zero at the bit of pattern position j
exactly when the pattern's suffix from j aligns to a prefix of the text's
suffix from i with at most d edits. So a window is the plain DP

    D(i, j) = min(D(i+1, j+1) + [text[i] != pattern[j]],  match or X
                  D(i, j+1) + 1,                          I
                  D(i+1, j) + 1)                          D
    D(i, m) = 0, D(n, j) = m - j

over the window's n text and m pattern characters, with R[d][i] bit j
zero iff D(i, j) <= d. The window's edit distance is D(0, 0) (the first
row that matches at column 0, with early termination or without); past K
the pair cannot be aligned. The traceback starts at (0, 0, D(0, 0)) and
takes, in this order of priority, I if D(i, j+1) <= d-1, D if D(i+1, j)
<= d-1, X if D(i+1, j+1) <= d-1, else =, with the reference's special
cases at the pattern's last character and at the end of the text; it
stops when the pattern is consumed or when i or j reaches W - O. Runs are
flushed a window, never merged across windows, and the window advances by
what the traceback consumed.

A row of D is computed from the row below it in one pass over all pairs:
with X_j the better of the diagonal and the deletion term, D(i, j) is the
suffix minimum of X_k + (k - j) over k >= j. Pairs run in lockstep, a
window at a time; the pattern is right-aligned in the W + 1 columns so that
every pair's boundary column m sits at column W.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

OPS = "=XID"
EQ, X, INS, DEL = 0, 1, 2, 3
# the traceback's order of priority; CONTROL_PRIORITY swaps I and D, which
# keeps every alignment optimal and changes its CIGAR
PRIORITY = (INS, DEL, X)
CONTROL_PRIORITY = (DEL, INS, X)

_LUT = np.full(256, 255, np.uint8)
_LUT[np.frombuffer(b"ACGTacgt", np.uint8)] = [0, 1, 2, 3, 0, 1, 2, 3]


def encode(seq: str) -> np.ndarray:
    """ASCII -> 2-bit codes. Raises ValueError on a character not ACGT."""
    codes = _LUT[np.frombuffer(seq.encode("ascii"), np.uint8)]
    if codes.size and codes.max() == 255:
        raise ValueError("non-ACGT character in sequence")
    return codes


def max_windows(W: int, O: int, read_len: int) -> int:
    """The reference's bound on windows a read of ``read_len`` takes
    (config.max_windows): the text a pair may read is this many windows'
    W - O characters, plus W."""
    if read_len <= 0:
        return 1
    return int(np.ceil(read_len * 1.34 / max(1, W - O))) + 4


@dataclass
class Result:
    """Per pair: edit distance (-1: no alignment within K in some window),
    CIGAR (None where -1), and the work the alignment takes: DP cells of
    the rows filled (with early termination rows 0..D(0, 0) of each window,
    without rows 0..K, n + 1 cells a row), traceback steps, CIGAR runs and
    windows."""

    eds: np.ndarray
    cigars: List[Optional[str]]
    cells: np.ndarray
    steps: np.ndarray
    runs: np.ndarray
    windows: np.ndarray


def _cigar(ops: List[np.ndarray]):
    """(CIGAR, runs) of a pair's per-window op sequences."""
    if not ops:
        return "", 0
    seq = np.concatenate(ops)
    wid = np.repeat(np.arange(len(ops)), [len(o) for o in ops])
    cut = np.flatnonzero((seq[1:] != seq[:-1]) | (wid[1:] != wid[:-1])) + 1
    starts = np.concatenate([[0], cut])
    counts = np.diff(np.concatenate([starts, [len(seq)]]))
    return ("".join(f"{c}{OPS[o]}" for c, o in zip(counts.tolist(),
                                                      seq[starts].tolist())),
            len(starts))


def align(texts: Sequence[np.ndarray], reads: Sequence[np.ndarray], W: int,
          K: int, O: int, early_termination: bool = True,
          priority=PRIORITY) -> Result:
    """Align each read (2-bit codes) semiglobally to the start of its text
    (2-bit codes, the reference from the candidate position on)."""
    B = len(reads)
    tb = W - O
    tlen = np.array([len(t) for t in texts], np.int64)
    plen = np.array([len(r) for r in reads], np.int64)
    # padded past every window's reach: text 4 and pattern 5 never match
    T = np.full((B, int(tlen.max(initial=0)) + W + 1), 4, np.uint8)
    P = np.full((B, int(plen.max(initial=0)) + W + 1), 5, np.uint8)
    for b in range(B):
        T[b, : tlen[b]] = texts[b]
        P[b, : plen[b]] = reads[b]
    rows = np.arange(B)
    col = np.arange(W + 1, dtype=np.int32)
    bound = (W - col)[None, :].astype(np.int32)  # D(n, j) = m - j

    ref_idx = np.zeros(B, np.int64)
    read_idx = np.zeros(B, np.int64)
    ed = np.zeros(B, np.int64)
    bad = np.zeros(B, bool)
    done = plen <= 0
    cells = np.zeros(B, np.int64)
    steps = np.zeros(B, np.int64)
    windows = np.zeros(B, np.int64)
    ops: List[List[np.ndarray]] = [[] for _ in range(B)]
    guard = 4 * max_windows(W, O, int(plen.max(initial=0))) + 4
    D = np.empty((B, W + 1, W + 1), np.int32)

    while not done.all():
        guard -= 1
        if guard < 0:
            raise RuntimeError("a window made no progress")
        act = ~done
        n = np.where(act, np.clip(tlen - ref_idx, 0, W), 0)
        m = np.where(act, np.clip(plen - read_idx, 0, W), 0)
        shift = W - m  # pattern position j sits at column j + shift
        tw = T[rows[:, None], ref_idx[:, None] + col[:W]]
        src = col[None, :W] - shift[:, None]
        pr = np.where(src >= 0, P[rows[:, None],
                                  read_idx[:, None] + np.maximum(src, 0)], 6)

        # ---- the DP, a text position (row) at a time, from i = W down ----
        prev = np.broadcast_to(bound, (B, W + 1))
        at_n = n[:, None]
        for i in range(W, -1, -1):
            if i < W:
                x = np.empty((B, W + 1), np.int32)
                np.minimum(prev[:, 1:] + (tw[:, i : i + 1] != pr),
                           prev[:, :W] + 1, out=x[:, :W])
                x[:, W] = 0
                x += col
                cur = np.minimum.accumulate(x[:, ::-1], axis=1)[:, ::-1]
                cur -= col
                cur = np.where(at_n == i, bound, cur)
            else:
                cur = np.broadcast_to(bound, (B, W + 1))
            D[:, i] = cur
            prev = cur
        wed = D[rows, 0, shift].astype(np.int64)
        fail = act & (wed > K)
        ok = act & ~fail
        bad |= fail
        rows_filled = wed + 1 if early_termination else K + 1
        cells += np.where(ok, rows_filled * (n + 1), 0)
        windows += ok

        # ---- the traceback, a step at a time over every pair ----
        i = np.zeros(B, np.int64)
        j = np.zeros(B, np.int64)
        d = wed.copy()
        hist = []
        while True:
            run = ok & (j < m) & (i < tb) & (j < tb)
            if not run.any():
                break
            ilim = i >= n
            dlim = d == 0
            jlast = j == m - 1
            jc = j + shift
            i1 = np.minimum(i + 1, W)
            j1 = np.minimum(jc + 1, W)
            can = {
                INS: ~dlim & (jlast | (D[rows, i, j1] <= d - 1)),
                DEL: ~dlim & ~jlast & ~ilim & (D[rows, i1, jc] <= d - 1),
                X: ~dlim & ~ilim & (jlast | (D[rows, i1, j1] <= d - 1)),
            }
            op = np.full(B, EQ, np.int8)
            for p in reversed(priority):
                op[can[p]] = p
            op[~run] = -1
            hist.append(op)
            i += run & (op != INS)
            j += run & (op != DEL)
            d -= run & (op != EQ)
        steps += (np.array(hist) >= 0).sum(0) if hist else 0
        H = np.array(hist, np.int8).reshape(len(hist), B)
        for b in np.flatnonzero(ok):
            h = H[:, b]
            ops[b].append(h[h >= 0])

        stalled = ok & (i == 0) & (j == 0)
        bad |= stalled
        good = ok & ~stalled
        ed += np.where(good, wed - d, 0)
        ref_idx += np.where(good, i, 0)
        read_idx += np.where(good, j, 0)
        done |= bad | (read_idx >= plen)

    cigars: List[Optional[str]] = []
    runs = np.zeros(B, np.int64)
    for b in range(B):
        if bad[b]:
            cigars.append(None)
            continue
        c, runs[b] = _cigar(ops[b])
        cigars.append(c)
    return Result(np.where(bad, -1, ed), cigars, cells, steps, runs, windows)
