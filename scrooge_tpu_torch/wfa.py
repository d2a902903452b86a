"""First-party wavefront alignment (WFA) baseline.

The port's own copy of ``scrooge_tpu/wfa.py`` (numpy on the host, as the
reference's ``cpu_baseline`` runs its baselines on the CPU).

The reference vendors two third-party wavefront aligners and benchmarks
GenASM against them: WFA (exact + adaptive, driven at
cpu_baseline.cpp:487-549 / :552-614, linked as ``libwfa``) and the
low-memory header-only ``wfa_lm`` (cpu_baseline.cpp:387-438). Both are run
in gap-affine *penalty* space (matches free, mismatch ``x``, a gap of
length L costs ``o + e*L``) over a text window of exactly read length
(``input.n = min(m, ...)``, cpu_baseline.cpp:516-517), i.e. global
alignment of the read against a same-length reference window; scores are
then rescored from the CIGAR under the common affine model like every
other baseline (cpu_baseline.cpp:694-725).

This module fills both roles with an independent implementation of the
exact wavefront algorithm (Marco-Sola et al., doi:10.1093/bioinformatics/
btaa777 — implemented from the recurrences, no reference code consulted):

 - ``wfa_global``: exact gap-affine WFA with full traceback (the
   ``wfa_exact`` role). O(ns) time, O(s^2) memory for s = optimal penalty.
 - ``wfa_semiglobal``: ends-free variant matching this repo's semiglobal
   target function (whole query vs a prefix of text) — terminates when any
   wavefront first consumes the query.
 - ``wfa_distance``: penalty-only, keeps just the trailing max(x, o+e)
   score levels (the ``wfa_lm`` low-memory role).

All three are exact: tests pin them against an independent min-plus Gotoh
oracle (tests/test_baselines.py), and the port's copy against them
(tests/test_torch_baselines.py).

Wavefront bookkeeping: diagonal k = h - v (h = text chars consumed,
v = query chars consumed), offsets store h. Per penalty s three compact
arrays M/I/D over the live diagonal range [lo, hi]; ``I`` consumes a query
character (CIGAR 'I', k-1 from k), ``D`` consumes a text character
(CIGAR 'D', k+1 from k), matching this repo's CIGAR convention.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

NEG = np.int32(-(1 << 30))
_NEG_HALF = int(NEG) // 2


class _Wave:
    """Wavefronts for one penalty level: arrays over diagonals [lo, hi]."""

    __slots__ = ("lo", "M", "I", "D")

    def __init__(self, lo: int, M: np.ndarray, I: np.ndarray,
                 D: np.ndarray):
        self.lo = lo
        self.M = M
        self.I = I
        self.D = D

    @property
    def hi(self) -> int:
        return self.lo + len(self.M) - 1

    def at(self, arr_name: str, k: int) -> int:
        i = k - self.lo
        if 0 <= i < len(self.M):
            return int(getattr(self, arr_name)[i])
        return int(NEG)


def _shifted(w: Optional[_Wave], arr_name: str, shift: int, lo: int,
             size: int) -> np.ndarray:
    """Array over diagonals [lo, lo+size): value at k taken from the
    source wavefront at diagonal k + shift (NEG where out of range)."""
    out = np.full(size, NEG, np.int32)
    if w is None:
        return out
    src = getattr(w, arr_name)
    # out[i] = src[(lo + i + shift) - w.lo]
    off = lo + shift - w.lo
    s0 = max(0, -off)
    s1 = min(size, len(src) - off)
    if s1 > s0:
        out[s0:s1] = src[s0 + off : s1 + off]
    return out


def _extend(M: np.ndarray, lo: int, t: np.ndarray, q: np.ndarray) -> None:
    """In-place match extension along each diagonal (h,v both advance
    while text[h] == query[v])."""
    n, m = len(t), len(q)
    ks = lo + np.arange(len(M), dtype=np.int64)
    cap = np.minimum(n, m + ks)  # max h with v <= m and h <= n
    idx = np.where((M > _NEG_HALF) & (M >= np.maximum(ks, 0))
                   & (M < cap))[0]
    while idx.size:
        h = M[idx].astype(np.int64)
        v = h - ks[idx]
        eq = t[h] == q[v]
        idx = idx[eq]
        if idx.size == 0:
            break
        M[idx] += 1
        idx = idx[M[idx] < cap[idx]]


def _wfa_fill(t: np.ndarray, q: np.ndarray, x: int, o: int, e: int,
              semiglobal: bool, keep: int = 0
              ) -> Tuple[int, int, List[Optional[_Wave]]]:
    """Run wavefronts until the target boundary is reached.

    Returns (penalty, final diagonal k, per-score wavefront list). With
    ``keep > 0`` only the trailing ``keep`` levels are retained (earlier
    slots become None) — the low-memory mode; traceback then impossible.
    """
    n, m = len(t), len(q)
    waves: List[Optional[_Wave]] = []

    def done(w: _Wave) -> Optional[int]:
        ks = w.lo + np.arange(len(w.M), dtype=np.int64)
        if semiglobal:
            ok = (w.M > _NEG_HALF) & (w.M - ks == m) & (w.M <= n)
            if ok.any():
                # deterministic pick: least text consumed
                return int(ks[ok][np.argmin(w.M[ok])])
        else:
            k0 = n - m
            if w.at("M", k0) == n:
                return k0
        return None

    M0 = np.zeros(1, np.int32)
    _extend(M0, 0, t, q)
    w = _Wave(0, M0, np.full(1, NEG, np.int32), np.full(1, NEG, np.int32))
    waves.append(w)
    k = done(w)
    if k is not None:
        return 0, k, waves

    s_cap = x * min(n, m) + 2 * (o + e * (n + m)) + 1
    for s in range(1, s_cap):
        wm = waves[s - x] if s >= x else None          # mismatch source
        wo = waves[s - o - e] if s >= o + e else None  # gap-open source
        we = waves[s - e] if s >= e else None          # gap-extend source

        los = [v.lo for v in (wm, wo, we) if v is not None]
        his = [v.hi for v in (wm, wo, we) if v is not None]
        if not los:
            waves.append(None)
            continue
        lo = max(min(los) - 1, -m)
        hi = min(max(his) + 1, n)
        size = hi - lo + 1
        ks = lo + np.arange(size, dtype=np.int64)
        cap = np.minimum(n, m + ks)

        # I (query gap char): from diagonal k+1, offset h unchanged;
        # source must still have a query char to give (v_src < m).
        mo = _shifted(wo, "M", +1, lo, size)
        mo = np.where(mo - (ks + 1) < m, mo, NEG)
        ie = _shifted(we, "I", +1, lo, size)
        ie = np.where(ie - (ks + 1) < m, ie, NEG)
        I = np.maximum(mo, ie)

        # D (text gap char): from diagonal k-1, offset h+1 <= n.
        mo = _shifted(wo, "M", -1, lo, size)
        de = _shifted(we, "D", -1, lo, size)
        D = np.maximum(mo, de)
        D = np.where((D > _NEG_HALF) & (D + 1 <= n), D + 1, NEG)

        # mismatch: same diagonal, h and v both advance.
        mm = _shifted(wm, "M", 0, lo, size)
        mm = np.where((mm > _NEG_HALF) & (mm < cap), mm + 1, NEG)

        M = np.maximum(np.maximum(I, D), mm)
        bad = (M <= _NEG_HALF) | (M < np.maximum(ks, 0)) | (M > cap)
        M[bad] = NEG
        if (M <= _NEG_HALF).all() and (I <= _NEG_HALF).all() \
                and (D <= _NEG_HALF).all():
            waves.append(None)
            continue
        _extend(M, lo, t, q)
        w = _Wave(lo, M, I, D)
        waves.append(w)
        if keep and s - keep >= 0:
            waves[s - keep] = None
        k = done(w)
        if k is not None:
            return s, k, waves
    raise RuntimeError("WFA did not converge (internal error)")


def _wat(waves: List[Optional[_Wave]], s: int, name: str, k: int) -> int:
    if s < 0 or waves[s] is None:
        return int(NEG)
    return waves[s].at(name, k)


def _traceback(waves: List[Optional[_Wave]], s: int, k: int, t: np.ndarray,
               q: np.ndarray, x: int, o: int, e: int) -> str:
    """Walk the stored wavefronts back to (0, 0), rebuilding the CIGAR."""
    ops: List[str] = []  # reversed
    h = waves[s].at("M", k)
    state = "M"
    while True:
        if state == "M":
            w = waves[s]
            mm = _wat(waves, s - x, "M", k)
            mm = mm + 1 if mm > _NEG_HALF else int(NEG)
            iv = w.at("I", k)
            dv = w.at("D", k)
            h0 = max(mm, iv, dv)
            if s == 0 or h0 <= _NEG_HALF:
                # origin: the remaining offset is the leading match run
                ops.append("=" * h)
                break
            ops.append("=" * (h - h0))
            h = h0
            if h == mm:
                ops.append("X")
                s -= x
                h -= 1
            elif h == iv:
                state = "I"
            else:
                state = "D"
        elif state == "I":
            ops.append("I")
            mo = _wat(waves, s - o - e, "M", k + 1)
            k += 1
            if mo == h:
                s -= o + e
                state = "M"
            else:
                s -= e
        else:  # D
            ops.append("D")
            h -= 1
            k -= 1
            mo = _wat(waves, s - o - e, "M", k)
            if mo == h:
                s -= o + e
                state = "M"
            else:
                s -= e
    from .baselines import _rle

    return _rle("".join(reversed(ops)))


def _encode(text: str, query: str) -> Tuple[np.ndarray, np.ndarray]:
    return (np.frombuffer(text.encode(), np.uint8).astype(np.int64),
            np.frombuffer(query.encode(), np.uint8).astype(np.int64))


def wfa_global(text: str, query: str, x: int = 4, o: int = 6,
               e: int = 2) -> Tuple[int, str]:
    """Exact gap-affine wavefront alignment, global (both sequences fully
    consumed) — the ``wfa_exact`` role (cpu_baseline.cpp:487-549).
    Returns (penalty, extended CIGAR); matches cost 0, a mismatch ``x``,
    a length-L gap ``o + e*L``."""
    n, m = len(text), len(query)
    if m == 0:
        return (o + e * n, f"{n}D") if n else (0, "")
    if n == 0:
        return o + e * m, f"{m}I"
    t, q = _encode(text, query)
    s, k, waves = _wfa_fill(t, q, x, o, e, semiglobal=False)
    return s, _traceback(waves, s, k, t, q, x, o, e)


def wfa_semiglobal(text: str, query: str, x: int = 4, o: int = 6,
                   e: int = 2) -> Tuple[int, str]:
    """Exact gap-affine wavefront alignment, semiglobal: the whole query
    against a prefix of text (this repo's target function, README.md:79),
    under WFA penalty scoring. Returns (penalty, extended CIGAR)."""
    n, m = len(text), len(query)
    if m == 0:
        return 0, ""
    if n == 0:
        return o + e * m, f"{m}I"
    t, q = _encode(text, query)
    s, k, waves = _wfa_fill(t, q, x, o, e, semiglobal=True)
    return s, _traceback(waves, s, k, t, q, x, o, e)


def wfa_distance(text: str, query: str, x: int = 4, o: int = 6, e: int = 2,
                 semiglobal: bool = True) -> int:
    """Penalty-only wavefront alignment keeping just the trailing
    max(x, o+e) score levels — the low-memory ``wfa_lm`` role
    (cpu_baseline.cpp:387-438, wfalm::wavefront_align_low_mem)."""
    n, m = len(text), len(query)
    if m == 0:
        return 0 if semiglobal else (o + e * n if n else 0)
    if n == 0:
        return o + e * m
    t, q = _encode(text, query)
    s, _, _ = _wfa_fill(t, q, x, o, e, semiglobal=semiglobal,
                        keep=max(x, o + e) + 1)
    return s
