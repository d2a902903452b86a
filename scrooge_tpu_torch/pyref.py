"""Scalar Python oracle for the GenASM/Scrooge algorithm.

The port's own copy of ``scrooge_tpu/pyref.py``: a direct
reimplementation of the reference's semantics
(genasm_cpu.cpp:210-438) with arbitrary-precision Python ints as
bitvectors. The engine's failed lanes are redone here, ``backend="pyref"``
runs every pair here, and the tests and ``chip_smoke.py`` hold the engine
against it.

 - Pattern masks: mask[c] has a ZERO at bit (m-1-j) for every pattern
   position j with pattern[j]==c (genasm_cpu.cpp:178-198).
 - DP recurrence (genasm_cpu.cpp:214-252):
     d==0 && i==n : all-ones
     d==0         : center = (right << 1) | pm[text[i]]
     i==n         : center = ones << d
     else         : center = mat & sub & ins & del with
                    mat=(right<<1)|pm, sub=topright<<1, ins=top<<1,
                    del=topright
 - Window edit distance = first d whose i==0 entry has a zero at bit m-1
   (genasm_cpu.cpp:278-283).
 - Traceback (genasm_cpu.cpp:290-409): start at (i=0, j=0, d=window_ed);
   stop when j==m or i>=TB_LIMIT or j>=TB_LIMIT; priority I > D > X > '='
   with '=' as the fallback; trailing deletes ignored; runs flushed per
   window, never merged across windows.
 - Windowing (genasm_cpu.cpp:411-438): n=min(W, ref left), m=min(W, read
   left); advance by (text consumed, pattern consumed).

Both R layouts (entries or edges, full or DENT-truncated) are kept; they
give identical output by construction.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from .config import AlignConfig

# SCROOGE_DEBUG=1 turns on the reference's DEBUG-gated traceback dead-end
# check (genasm_cpu.cpp:307-385): every '=' fallback step must be justified
# by a zero in the DP table (can_mat), or the traceback has left every
# optimal path, a table fault that is then caught where it happens.
DEBUG = bool(int(os.environ.get("SCROOGE_DEBUG", "0") or "0"))


class TracebackDeadEnd(AssertionError):
    """The traceback reached a state on no optimal path (the reference's
    assert(false), genasm_cpu.cpp:362-385)."""


_ENCODE = {"A": 0, "a": 0, "C": 1, "c": 1, "G": 2, "g": 2, "T": 3, "t": 3}


def encode(seq: str) -> List[int]:
    """ASCII -> zero-based codes (genasm_cpu.cpp:462-493). Raises on non-ACGT."""
    try:
        return [_ENCODE[c] for c in seq]
    except KeyError as e:
        raise ValueError(f"non-ACGT character in sequence: {e}") from e


class _BV:
    """Fixed-width bitvector helpers over Python ints."""

    def __init__(self, bits: int):
        self.bits = bits
        self.mask = (1 << bits) - 1

    def ones(self) -> int:
        return self.mask

    def shl(self, v: int, amount: int = 1) -> int:
        return (v << amount) & self.mask

    @staticmethod
    def has_zero_at(v: int, bit: int) -> bool:
        return ((v >> bit) & 1) == 0


def _pattern_masks(bv: _BV, m: int, pattern: List[int]) -> List[int]:
    """genasm_cpu.cpp:178-198: zero at bit m-1-j where pattern[j]==c."""
    masks = [bv.ones()] * 4
    for bit_idx in range(m):
        j = m - 1 - bit_idx
        masks[pattern[j]] &= bv.mask ^ (1 << bit_idx)
    return masks


class _RTable:
    """The stored DP table R in any of the 4 layout modes.

    Indexed [d][i]; in entries mode each element is the cell value, in
    edges mode a (mat, ins, del) triple. With DENT, only columns
    i < W-O+1 are stored and each value keeps its top TB_BITS bits
    (genasm_cpu.cpp:200-208); TB_BIT(j) maps accordingly (:56-60).
    """

    def __init__(self, cfg: AlignConfig, m: int):
        self.sene = cfg.store_entries_not_edges
        self.dent = cfg.discard_entries_not_used_by_traceback
        self.m = m
        self.columns = cfg.columns if self.dent else cfg.W + 1
        self.tb_bits = min(cfg.W - cfg.O + 1, m)
        self.non_tb_bits = m - self.tb_bits
        self.store: dict = {}

    def _truncate(self, v: int) -> int:
        return v >> self.non_tb_bits  # bits [non_tb_bits, m) -> [0, tb_bits)

    def tb_bit(self, j: int) -> int:
        if self.dent:
            return self.tb_bits - 1 - j
        return self.m - 1 - j

    def put(self, i: int, d: int, center: int, mat: int, ins: int, dele: int):
        if self.dent and i >= self.columns:
            return
        if self.sene:
            self.store[(i, d)] = self._truncate(center) if self.dent else center
        else:
            if self.dent:
                mat, ins, dele = (self._truncate(x) for x in (mat, ins, dele))
            self.store[(i, d)] = (mat, ins, dele)

    def zero_at(self, i: int, d: int, j: int, edge: Optional[int] = None) -> bool:
        v = self.store[(i, d)]
        if not self.sene:
            v = v[edge]
        return ((v >> self.tb_bit(j)) & 1) == 0


# edge indices for edges-mode storage (genasm_cpu.cpp:80-83)
EDGE_MAT, EDGE_INS, EDGE_DEL = 0, 1, 2


def genasm_dc(n: int, text: List[int], m: int, pattern: List[int],
              cfg: AlignConfig) -> Tuple[int, _RTable]:
    """DP fill for one window (genasm_cpu.cpp:210-288). Returns
    (window_edit_distance, R); raises ValueError if no row d <= K matches
    (the reference would assert in the traceback)."""
    bv = _BV(cfg.W)
    pm = _pattern_masks(bv, m, pattern)
    R = _RTable(cfg, m)
    forefront = [0] * (cfg.W + 1)
    window_edit_distance: Optional[int] = None

    for d in range(cfg.K + 1):
        right = topright = top = 0
        for i in range(n, -1, -1):
            cur_pm = pm[text[i]] if i < n else 0
            if d > 0:
                top = forefront[i]
            if d == 0 and i == n:
                mat = ins = dele = center = bv.ones()
            elif d == 0:
                mat = bv.shl(right) | cur_pm
                ins = dele = bv.ones()
                center = mat
            elif i == n:
                mat = dele = bv.ones()
                ins = bv.shl(bv.ones(), d)
                center = ins
            else:
                mat = bv.shl(right) | cur_pm
                ins = bv.shl(top)
                dele = topright
                center = mat & bv.shl(topright) & ins & dele
            right = center
            topright = top
            forefront[i] = center
            R.put(i, d, center, mat, ins, dele)
            if i == 0 and _BV.has_zero_at(center, m - 1):
                if window_edit_distance is None:
                    window_edit_distance = d
                if cfg.early_termination:
                    return d, R
        if window_edit_distance is not None and cfg.early_termination:
            break

    if window_edit_distance is None:
        raise ValueError(
            f"no alignment within K={cfg.K} edits for window (n={n}, m={m}); "
            "reference would assert (genasm_cpu.cpp:294-301)")
    return window_edit_distance, R


def genasm_tb(n: int, m: int, R: _RTable, window_edit_distance: int,
              cfg: AlignConfig) -> Tuple[int, int, int, List[Tuple[int, str]]]:
    """Traceback for one window (genasm_cpu.cpp:290-409). Returns
    (edits_used, text_consumed, pattern_consumed, runs), runs being this
    window's run-length CIGAR as (count, op) tuples."""
    i = j = 0
    d = window_edit_distance
    tb_limit = cfg.tb_limit
    sene = cfg.store_entries_not_edges
    runs: List[Tuple[int, str]] = []
    cur_type = " "
    cur_count = 0

    while j < m:
        if i >= tb_limit or j >= tb_limit:
            break
        i_limit = i >= n
        d_limit = d == 0
        can_mat = True
        if j < m - 1:
            if sene:
                can_ins = (not d_limit) and R.zero_at(i, d - 1, j + 1)
                can_del = ((not d_limit) and (not i_limit)
                           and R.zero_at(i + 1, d - 1, j))
                can_sub = ((not d_limit) and (not i_limit)
                           and R.zero_at(i + 1, d - 1, j + 1))
                if DEBUG:  # genasm_cpu.cpp:325-326
                    can_mat = (not i_limit) and R.zero_at(i + 1, d, j + 1)
            else:
                can_ins = R.zero_at(i, d, j, EDGE_INS)
                can_del = R.zero_at(i, d, j, EDGE_DEL)
                can_sub = R.zero_at(i, d, j + 1, EDGE_DEL)
                if DEBUG:  # genasm_cpu.cpp:332-333
                    can_mat = R.zero_at(i, d, j, EDGE_MAT)
        else:
            can_ins = not d_limit
            can_del = False
            can_sub = (not d_limit) and (not i_limit)
            if DEBUG:  # genasm_cpu.cpp:341-342
                can_mat = d == 0

        if DEBUG and not (can_ins or can_del or can_sub or can_mat):
            raise TracebackDeadEnd(  # genasm_cpu.cpp:362-385
                f"traceback dead end at i={i} j={j} d={d} n={n} m={m}")

        if can_ins:
            j += 1
            d -= 1
            op = "I"
        elif can_del:
            i += 1
            d -= 1
            op = "D"
        elif can_sub:
            i += 1
            j += 1
            d -= 1
            op = "X"
        else:
            i += 1
            j += 1
            op = "="

        if op != cur_type:
            if cur_count > 0:
                runs.append((cur_count, cur_type))
            cur_type = op
            cur_count = 1
        else:
            cur_count += 1

    if cur_count > 0:
        runs.append((cur_count, cur_type))
    return window_edit_distance - d, i, j, runs


def genasm(ref: List[int], read: List[int], cfg: AlignConfig) -> Tuple[int, str]:
    """Windowed alignment of one (reference view, read) pair
    (genasm_cpu.cpp:411-438). Returns (edit_distance, cigar)."""
    ref_idx = read_idx = edit_distance = 0
    cigar_parts: List[str] = []
    guard = 4 * cfg.max_windows(len(read)) + 4
    while read_idx < len(read):
        guard -= 1
        if guard < 0:
            raise RuntimeError(
                "window loop stalled (no progress); reference would loop forever")
        n = min(cfg.W, len(ref) - ref_idx)
        m = min(cfg.W, len(read) - read_idx)
        # the C++ reads text[n] at i==n but never uses it; exactly n chars
        # are passed here
        window_ed, R = genasm_dc(n, ref[ref_idx : ref_idx + n], m,
                                 read[read_idx : read_idx + m], cfg)
        edits_used, text_consumed, pattern_consumed, runs = genasm_tb(
            n, m, R, window_ed, cfg)
        cigar_parts.extend(f"{count}{op}" for count, op in runs)
        edit_distance += edits_used
        ref_idx += text_consumed
        read_idx += pattern_consumed
    return edit_distance, "".join(cigar_parts)


def align_pair(text: str, query: str,
               cfg: Optional[AlignConfig] = None) -> Tuple[int, str]:
    """Align one ASCII pair; text = reference segment, query = read."""
    return genasm(encode(text), encode(query), cfg or AlignConfig())
