"""Built-in baseline aligners for accuracy comparison.

The port's own copy of ``scrooge_tpu/baselines.py``. These are CPU
baselines in the reference too (its ``cpu_baseline`` binary), so they stay
numpy on the host; only the GenASM engine runs on the card.

The reference vendors third-party baselines (edlib, ksw2, WFA — ~22k LoC,
baseline_algorithms/) and compares GenASM accuracy/throughput against them
(cpu_baseline.cpp:727-875). This module provides first-party equivalents of
the comparison roles those baselines play:

 - ``exact_semiglobal``: EXACT semiglobal edit distance + traceback (the
   accuracy gold standard edlib fills in the reference, EDLIB_MODE_SHW,
   cpu_baseline.cpp:355), as vectorized numpy row-DP.
 - ``affine_semiglobal``: exact affine-gap scoring (the ksw2 / WFA-exact
   role, cpu_baseline.cpp:155-292).
 - ``banded_semiglobal``: adaptive band-doubling edit-distance aligner
   (the WFA-adaptive / banded role, cpu_baseline.cpp:418-453): exact
   results, O(m*band) work on easy pairs.
 - ``wfa_global`` / ``wfa_semiglobal`` / ``wfa_distance`` (re-exported
   from wfa.py): first-party exact wavefront aligner — the wfa_exact and
   low-memory wfa_lm roles (cpu_baseline.cpp:487-549, :387-438).
 - ``local_affine``: exact local Smith-Waterman-Gotoh (the CUDASW++
   role — the one vendored baseline with a *local* target function).
 - ``edlib_semiglobal``: optional cross-check through the third-party
   edlib, the PyPI package or its sources compiled from
   ``SCROOGE_EDLIB_SRC`` (tests skip when neither is there).

Affine-gap rescoring for score comparisons lives in cigar.py.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _fill_rows(t: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Full DP table D[i, j] = min edits aligning query[:i] to text[:j]."""
    n, m = len(t), len(q)
    D = np.zeros((m + 1, n + 1), np.int32)
    D[0, :] = np.arange(n + 1)
    D[:, 0] = np.arange(m + 1)
    jj = np.arange(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        sub = D[i - 1, :-1] + (t != q[i - 1])
        ins = D[i - 1, 1:] + 1
        v = np.minimum(sub, ins)  # j = 1..n, before deletions
        # deletions: cur[j] = min_{k<=j} a[k] + (j-k) with a[0]=i, a[j]=v[j]
        a = np.concatenate(([np.int32(i)], v))
        p = np.minimum.accumulate(a - jj)
        D[i] = p + jj
    return D


def exact_semiglobal(text: str, query: str) -> Tuple[int, str]:
    """Exact semiglobal alignment: whole query vs a prefix of text.

    Semantics match GenASM's target function (README.md:79): the entire
    query must be consumed; the alignment starts at text[0] and may end
    anywhere (min over text prefixes of the Levenshtein distance).
    Returns (edit_distance, extended CIGAR with '=XID' runs).
    """
    n, m = len(text), len(query)
    if m == 0:
        return 0, ""
    if n == 0:
        return m, f"{m}I"
    t = np.frombuffer(text.encode(), np.uint8)
    q = np.frombuffer(query.encode(), np.uint8)
    D = _fill_rows(t, q)

    end = int(np.argmin(D[m]))
    ed = int(D[m, end])

    runs = []

    def emit(op):
        if runs and runs[-1][1] == op:
            runs[-1][0] += 1
        else:
            runs.append([1, op])

    i, j = m, end
    while i > 0 or j > 0:
        if (i > 0 and j > 0
                and D[i, j] == D[i - 1, j - 1] + (t[j - 1] != q[i - 1])):
            emit("=" if t[j - 1] == q[i - 1] else "X")
            i, j = i - 1, j - 1
        elif i > 0 and D[i, j] == D[i - 1, j] + 1:
            emit("I")
            i -= 1
        else:
            emit("D")
            j -= 1
    return ed, "".join(f"{c}{op}" for c, op in reversed(runs))


def affine_semiglobal(text: str, query: str, match: int = 2,
                      mismatch: int = 4, gap_open: int = 4,
                      gap_extend: int = 2) -> Tuple[int, str]:
    """Exact affine-gap semiglobal alignment (Gotoh), the role ksw2/WFA
    play in the reference's accuracy comparisons (cpu_baseline.cpp:155-292;
    default scoring 2,4,4,2, cpu_baseline.cpp:885; a length-L gap costs
    gap_open + gap_extend*L, matching get_alignment_score).

    Whole query against a prefix of text, leading text gaps charged.
    Returns (score, extended CIGAR). Row-vectorized numpy O(nm).
    """
    n, m = len(text), len(query)
    NEG = np.int64(-(1 << 40))
    if m == 0:
        return 0, ""
    if n == 0:
        return -(gap_open + gap_extend * m), f"{m}I"
    t = np.frombuffer(text.encode(), np.uint8)
    q = np.frombuffer(query.encode(), np.uint8)

    jj = np.arange(n + 1, dtype=np.int64)
    H = np.empty((m + 1, n + 1), np.int64)
    E = np.full((m + 1, n + 1), NEG, np.int64)  # gap in query (D ops)
    F = np.full((m + 1, n + 1), NEG, np.int64)  # gap in text (I ops)
    H[0, 0] = 0
    E[0, 1:] = -(gap_open + gap_extend * jj[1:])
    H[0, 1:] = E[0, 1:]
    for i in range(1, m + 1):
        F[i, :] = np.maximum(H[i - 1, :] - gap_open - gap_extend,
                             F[i - 1, :] - gap_extend)
        diag = np.where(t == q[i - 1], match, -mismatch) + H[i - 1, :-1]
        h_no_e = np.empty(n + 1, np.int64)
        h_no_e[0] = F[i, 0]
        h_no_e[1:] = np.maximum(diag, F[i, 1:])
        # E[i, j] = max_{k<j} h_no_e[k] - gap_open - gap_extend*(j-k)
        u = np.maximum.accumulate(h_no_e + gap_extend * jj)
        E[i, 1:] = u[:-1] - gap_open - gap_extend * jj[1:]
        H[i, :] = np.maximum(h_no_e, E[i, :])
        H[i, 0] = -(gap_open + gap_extend * i)
        F[i, 0] = H[i, 0]  # a leading query gap is the only path here

    end = int(np.argmax(H[m]))
    score = int(H[m, end])

    # traceback through H/E/F
    runs = []

    def emit(op):
        if runs and runs[-1][1] == op:
            runs[-1][0] += 1
        else:
            runs.append([1, op])

    i, j, state = m, end, "H"
    while i > 0 or j > 0:
        if state == "H":
            if i > 0 and j > 0 and H[i, j] == H[i - 1, j - 1] + (
                    match if t[j - 1] == q[i - 1] else -mismatch):
                emit("=" if t[j - 1] == q[i - 1] else "X")
                i, j = i - 1, j - 1
            elif H[i, j] == E[i, j]:
                state = "E"
            elif H[i, j] == F[i, j]:
                state = "F"
            elif j > 0 and i == 0:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            emit("D")
            if j > 1 and E[i, j] == E[i, j - 1] - gap_extend:
                j -= 1
            else:
                j -= 1
                state = "H"
        else:  # F
            emit("I")
            if i > 1 and F[i, j] == F[i - 1, j] - gap_extend:
                i -= 1
            else:
                i -= 1
                state = "H"
    return score, "".join(f"{c}{op}" for c, op in reversed(runs))


def _banded_attempt(t: np.ndarray, q: np.ndarray, b: int):
    """One banded pass at half-width b; returns (ed, cigar) or None when
    no in-band path reaches row m. Slot k of a row holds column
    j = i + k - b (the Ukkonen diagonal band)."""
    n, m = len(t), len(q)
    width = 2 * b + 1
    INF = np.int32(1 << 28)
    ks = np.arange(width, dtype=np.int32)
    D = np.full((m + 1, width), INF, np.int32)
    j0 = ks - b
    row0_ok = (j0 >= 0) & (j0 <= n)
    D[0][row0_ok] = j0[row0_ok]
    for i in range(1, m + 1):
        j = i + ks - b
        valid = (j >= 0) & (j <= n)
        prev = D[i - 1]
        tj = np.clip(j - 1, 0, n - 1)
        mism = (t[tj] != q[i - 1]).astype(np.int32)
        sub = np.where(j >= 1, np.minimum(prev, INF) + mism, INF)
        ins = np.concatenate((prev[1:], [INF])) + 1  # same j, row i-1
        a = np.minimum(sub, ins)
        zslot = b - i  # slot where j == 0: i leading insertions
        if 0 <= zslot < width:
            a[zslot] = min(a[zslot], i)
        # deletions run along the row from smaller j (slot k-1) to k:
        # cur[k] = min_{k' <= k} a[k'] + (k - k')
        run = np.minimum.accumulate(a - ks) + ks
        cur = np.minimum(a, run)
        cur[~valid] = INF
        D[i] = cur
    endk = int(np.argmin(D[m]))
    ed = int(D[m][endk])
    if ed >= int(INF):
        return None

    runs = []

    def emit(op):
        if runs and runs[-1][1] == op:
            runs[-1][0] += 1
        else:
            runs.append([1, op])

    i, k = m, endk
    while i > 0 or (i + k - b) > 0:
        j = i + k - b
        cell = int(D[i, k])
        if (i > 0 and j > 0
                and cell == int(D[i - 1, k]) + (t[j - 1] != q[i - 1])):
            emit("=" if t[j - 1] == q[i - 1] else "X")
            i -= 1
        elif i > 0 and k + 1 < width and cell == int(D[i - 1, k + 1]) + 1:
            emit("I")
            i, k = i - 1, k + 1
        elif i > 0 and j == 0 and cell == i:
            emit("I")
            i, k = i - 1, k + 1
        else:
            emit("D")
            k -= 1
    return ed, "".join(f"{c}{op}" for c, op in reversed(runs))


def banded_semiglobal(text: str, query: str,
                      initial_band: int = 16) -> Tuple[int, str]:
    """Adaptive band-doubling semiglobal aligner (the banded/adaptive
    role WFA-adaptive plays in the reference, cpu_baseline.cpp:418-453).

    Runs the Ukkonen diagonal band at half-width b and doubles b until the
    computed distance is <= b (then no path can profitably leave the band,
    so the result equals the exact optimum — verified against
    exact_semiglobal in tests). Easy pairs finish at the initial band in
    O(m*b) work; worst case degrades to the full table.
    """
    n, m = len(text), len(query)
    if m == 0:
        return 0, ""
    if n == 0:
        return m, f"{m}I"
    t = np.frombuffer(text.encode(), np.uint8)
    q = np.frombuffer(query.encode(), np.uint8)
    b = max(1, initial_band)
    while True:
        out = _banded_attempt(t, q, b)
        if out is not None and (out[0] <= b or b >= n + m):
            return out
        b *= 2


NEG_INF = np.int32(-(1 << 29))


def _gact_tile(t: np.ndarray, q: np.ndarray, commit: int, mat: int,
               sub: int, gapo: int, gape: int):
    """One GACT tile: affine-gap DP anchored at the tile's far corner,
    forward traceback from (0, 0) committed for at most ``commit`` steps
    on either sequence. Returns (ops string, consumed_q, consumed_t)."""
    n, m = len(q), len(t)
    # backward DP: X[i][j] = best score aligning q[i:] vs t[j:] ending at
    # the far corner, with M/I/D the usual three affine states (I consumes
    # a query char, D a text char)
    M = np.full((n + 1, m + 1), NEG_INF, np.int32)
    I = np.full((n + 1, m + 1), NEG_INF, np.int32)
    D = np.full((n + 1, m + 1), NEG_INF, np.int32)
    M[n, m] = 0
    rem_t = (m - np.arange(m, dtype=np.int32)) * gape + gapo
    M[n, :m] = D[n, :m] = rem_t
    rem_q = (n - np.arange(n, dtype=np.int32)) * gape + gapo
    M[:n, m] = I[:n, m] = rem_q
    jj = np.arange(m + 1, dtype=np.int32)
    for i in range(n - 1, -1, -1):
        I[i, :m] = np.maximum(I[i + 1, :m], M[i + 1, :m] + gapo) + gape
        diag = M[i + 1, 1:] + np.where(q[i] == t, mat, sub)
        # In-row dependency D[i,j] = max(D[i,j+1], M[i,j+1]+gapo)+gape with
        # M[i,j] = max(diag, I, D): substituting G[j] = max(D[i,j],
        # M[i,j]+gapo) gives the pure suffix scan G[j] = max(G[j+1]+gape,
        # ND[j]+gapo) over ND = max(diag, I) (gapo <= 0 absorbs the
        # G+gape+gapo term), vectorized as a running max of G[j]+j*gape.
        nd = np.maximum(diag, I[i, :m])
        g = np.empty(m + 1, np.int32)
        g[:m] = nd + gapo + jj[:m] * gape
        g[m] = np.maximum(D[i, m], M[i, m] + gapo) + m * gape
        gs = np.maximum.accumulate(g[::-1])[::-1]  # suffix max of G+j*gape
        D[i, :m] = gs[1:] - jj[:m] * gape  # G[j+1] + gape - j*gape... see below
        M[i, :m] = np.maximum(nd, D[i, :m])
    ops = []
    i = j = 0
    state = "M"
    while i < commit and j < commit and i < n and j < m:
        if state == "M":
            # tie priority diagonal > I > D (the scheme's fill priority)
            diag = M[i + 1, j + 1] + (mat if q[i] == t[j] else sub)
            if M[i, j] != diag:
                state = "I" if M[i, j] == I[i, j] else "D"
        if state == "I":
            ops.append("I")
            state = "I" if I[i, j] == I[i + 1, j] + gape else "M"
            i += 1
        elif state == "D":
            ops.append("D")
            state = "D" if D[i, j] == D[i, j + 1] + gape else "M"
            j += 1
        else:
            ops.append("=" if q[i] == t[j] else "X")
            i += 1
            j += 1
    return "".join(ops), i, j


def gact_tiled(text: str, query: str, T: int = 320, O: int = 120,
               match: int = 2, mismatch: int = 4, gap_open: int = 4,
               gap_extend: int = 2) -> str:
    """First-party GACT-tiling aligner — the role the reference's custom
    GACT reimplementation plays as an accuracy-comparison target
    (cpu_baseline.cpp:455-484 drives baseline_algorithms/gact/gact.cpp:
    Darwin's tiled alignment: a T x T affine-gap DP tile anchored at the
    current position, traceback committed only for the first T-O steps,
    then the tile slides to the committed frontier).

    Independent implementation of the scheme, not a port: the D-state
    traceback follows the D matrix (the reference reads I_source in its
    D branch — an upstream quirk not replicated), and leftover query
    after the tile loop is emitted as trailing insertions so the CIGAR
    covers the query (our CIGAR-oracle contract; the reference drops the
    tail). Costs are passed as bonuses/penalties: match +2, mismatch -4,
    gaps -(4 + 2k) by default, matching the repo's affine_score
    convention. T=320/O=120 are the reference's tile shape
    (cpu_baseline.cpp:468-469); the text should span exactly the read
    length (the per-tile DP is global and pays for unconsumed text).
    """
    n, m = len(query), len(text)
    if n == 0:
        return ""
    if m == 0:
        return _rle(["I"] * n)
    q = np.frombuffer(query.encode(), np.uint8)
    t = np.frombuffer(text.encode(), np.uint8)
    ops_all: list = []
    i = j = 0
    while i < n and j < m:
        ops, ci, cj = _gact_tile(t[j : j + T], q[i : i + T], T - O,
                                 match, -mismatch, -gap_open, -gap_extend)
        if not ops:
            break
        ops_all.append(ops)
        i += ci
        j += cj
    if i < n:
        ops_all.append("I" * (n - i))
    return _rle("".join(ops_all))


def _rle(ops) -> str:
    out = []
    prev, cnt = "", 0
    for op in ops:
        if op == prev:
            cnt += 1
        else:
            if cnt:
                out.append(f"{cnt}{prev}")
            prev, cnt = op, 1
    if cnt:
        out.append(f"{cnt}{prev}")
    return "".join(out)


# --- third-party edlib (real library, not a reimplementation) ------------
# The reference links the vendored edlib sources directly
# (baseline_algorithms/edlib, Makefile:19-20) and races it in SHW mode
# (cpu_baseline.cpp:355). Here the same third-party sources, from the
# directory that SCROOGE_EDLIB_SRC names, are compiled at first use into
# the port's build directory (nothing vendored) and bound with ctypes; the
# PyPI `edlib` package is used instead when installed. Without either,
# edlib is reported unavailable.

_edlib_lib_cache: list = []  # [lib-or-None] once resolved


def _edlib_lib():
    import ctypes
    import os
    import subprocess

    from .buildcache import compile_once

    if _edlib_lib_cache:
        return _edlib_lib_cache[0]
    src_dir = os.environ.get("SCROOGE_EDLIB_SRC", "")
    cpp = os.path.join(src_dir, "edlib.cpp")
    lib = None
    if src_dir and os.path.exists(cpp):
        try:
            so, _ = compile_once(cpp, "g++", ("-O2", "-shared", "-fPIC",
                                              "-std=c++17", "-I", src_dir),
                                 timeout=300)
            lib = ctypes.CDLL(so)
        except (OSError, RuntimeError, subprocess.TimeoutExpired):
            lib = None
    if lib is not None:
        class _Cfg(ctypes.Structure):
            _fields_ = [("k", ctypes.c_int), ("mode", ctypes.c_int),
                        ("task", ctypes.c_int),
                        ("additionalEqualities", ctypes.c_void_p),
                        ("additionalEqualitiesLength", ctypes.c_int)]

        class _Res(ctypes.Structure):
            _fields_ = [("status", ctypes.c_int),
                        ("editDistance", ctypes.c_int),
                        ("endLocations", ctypes.POINTER(ctypes.c_int)),
                        ("startLocations", ctypes.POINTER(ctypes.c_int)),
                        ("numLocations", ctypes.c_int),
                        ("alignment", ctypes.POINTER(ctypes.c_ubyte)),
                        ("alignmentLength", ctypes.c_int),
                        ("alphabetLength", ctypes.c_int)]

        lib._Cfg, lib._Res = _Cfg, _Res
        lib.edlibAlign.restype = _Res
        lib.edlibAlign.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_int, _Cfg]
        lib.edlibFreeAlignResult.restype = None
        lib.edlibFreeAlignResult.argtypes = [_Res]
    _edlib_lib_cache.append(lib)
    return lib


def edlib_available() -> bool:
    """True when a real edlib is reachable (PyPI package, or compiled
    from the sources in SCROOGE_EDLIB_SRC)."""
    try:
        import edlib  # noqa: F401

        return True
    except ImportError:
        return _edlib_lib() is not None


def _edlib_ctypes_align(text: str, query: str, task: int):
    """(edit_distance, move-code bytes or None) via the ctypes binding.
    Moves: 0 match, 1 consume-query (I), 2 consume-text (D), 3 mismatch
    (edlib.h EDLIB_EDOP_*)."""
    lib = _edlib_lib()
    cfg = lib._Cfg(-1, 1, task, None, 0)  # k=auto, EDLIB_MODE_SHW
    q = query.encode("ascii")
    t = text.encode("ascii")
    res = lib.edlibAlign(q, len(q), t, len(t), cfg)
    try:
        if res.status != 0:
            raise RuntimeError("edlibAlign failed")
        ed = int(res.editDistance)
        moves = (bytes(res.alignment[: res.alignmentLength])
                 if task == 2 and res.alignmentLength > 0 else None)
    finally:
        lib.edlibFreeAlignResult(res)
    return ed, moves


def edlib_semiglobal(text: str, query: str) -> int:
    """Third-party cross-check: semiglobal edit distance through a real
    edlib (EDLIB_MODE_SHW, the mode the reference drives it in,
    cpu_baseline.cpp:355). Uses the PyPI package if installed, else the
    on-demand ctypes build (_edlib_lib); raises ImportError when neither
    exists (tests skip then)."""
    if len(query) == 0:
        return 0
    try:
        import edlib

        r = edlib.align(query, text, mode="SHW", task="distance")
        return int(r["editDistance"])
    except ImportError:
        if _edlib_lib() is None:
            raise
        return _edlib_ctypes_align(text, query, 0)[0]


_EDLIB_OPS = "=IDX"  # move code -> extended CIGAR op (edlib.h EDLIB_EDOP_*)


def edlib_semiglobal_cigar(text: str, query: str) -> Tuple[int, str]:
    """Semiglobal (SHW) edit distance + extended CIGAR via the real edlib
    (EDLIB_TASK_PATH — the reference's accuracy path, edlib_to_alignment,
    cpu_baseline.cpp:294-305). ctypes build only (the PyPI package also
    works but this keeps one code path); ImportError when unavailable."""
    if len(query) == 0:
        return 0, ""
    if len(text) == 0:  # edlib returns no path for an empty target
        return len(query), f"{len(query)}I"
    if _edlib_lib() is None:
        raise ImportError("no edlib available (set SCROOGE_EDLIB_SRC)")
    ed, moves = _edlib_ctypes_align(text, query, 2)
    out = []
    prev, cnt = "", 0
    for mv in moves or b"":
        op = _EDLIB_OPS[mv]
        if op == prev:
            cnt += 1
            continue
        if cnt:
            out.append(f"{cnt}{prev}")
        prev, cnt = op, 1
    if cnt:
        out.append(f"{cnt}{prev}")
    return ed, "".join(out)


def local_affine(text: str, query: str, match: int = 2, mismatch: int = 4,
                 gap_open: int = 4, gap_extend: int = 2
                 ) -> Tuple[int, str, int, int]:
    """Exact local affine-gap alignment (Smith-Waterman-Gotoh) — the role
    the CUDASW++ GPU baseline plays in the reference (profile.py:379-444
    drives it for throughput; it is the one vendored baseline whose
    target function is *local*, not semiglobal). Row-vectorized numpy.

    Returns (score, extended CIGAR of the local segment, query_start,
    text_start). The CIGAR covers only the aligned segment (local
    semantics) — it is not a semiglobal CIGAR and is not fed to the
    semiglobal validators.
    """
    n, m = len(text), len(query)
    if m == 0 or n == 0:
        return 0, "", 0, 0
    t = np.frombuffer(text.encode(), np.uint8)
    q = np.frombuffer(query.encode(), np.uint8)

    NEG = np.int64(-(1 << 40))
    jj = np.arange(n + 1, dtype=np.int64)
    H = np.zeros((m + 1, n + 1), np.int64)
    E = np.full((m + 1, n + 1), NEG, np.int64)  # gap in query (D ops)
    F = np.full((m + 1, n + 1), NEG, np.int64)  # gap in text (I ops)
    for i in range(1, m + 1):
        F[i, 1:] = np.maximum(H[i - 1, 1:] - gap_open - gap_extend,
                              F[i - 1, 1:] - gap_extend)
        diag = np.where(t == q[i - 1], match, -mismatch) + H[i - 1, :-1]
        h_no_e = np.maximum.reduce(
            [diag, F[i, 1:], np.zeros(n, np.int64)])
        # E[i, j] = max_{k<j} h_no_e-ish chain; same prefix-scan trick as
        # affine_semiglobal but with the local zero floor already folded
        # into h_no_e
        a = np.concatenate(([np.int64(0)], h_no_e))
        u = np.maximum.accumulate(a + gap_extend * jj)
        E[i, 1:] = u[:-1] - gap_open - gap_extend * jj[1:]
        H[i, 1:] = np.maximum(h_no_e, E[i, 1:])

    i, j = np.unravel_index(int(np.argmax(H)), H.shape)
    score = int(H[i, j])
    if score == 0:
        return 0, "", 0, 0

    runs = []

    def emit(op):
        if runs and runs[-1][1] == op:
            runs[-1][0] += 1
        else:
            runs.append([1, op])

    state = "H"
    while H[i, j] != 0 or state != "H":
        if state == "H":
            if H[i, j] == E[i, j]:
                state = "E"
            elif H[i, j] == F[i, j]:
                state = "F"
            else:
                emit("=" if t[j - 1] == q[i - 1] else "X")
                i, j = i - 1, j - 1
        elif state == "E":
            emit("D")
            if E[i, j] == E[i, j - 1] - gap_extend:
                j -= 1
            else:
                j -= 1
                state = "H"
        else:  # F
            emit("I")
            if F[i, j] == F[i - 1, j] - gap_extend:
                i -= 1
            else:
                i -= 1
                state = "H"
    cigar = "".join(f"{c}{op}" for c, op in reversed(runs))
    return score, cigar, int(i), int(j)


from .wfa import wfa_distance, wfa_global, wfa_semiglobal  # noqa: E402,F401


def semiglobal_distance(text: str, query: str) -> int:
    """Edit distance only, two-row memory."""
    n, m = len(text), len(query)
    if m == 0:
        return 0
    if n == 0:
        return m
    t = np.frombuffer(text.encode(), np.uint8)
    q = np.frombuffer(query.encode(), np.uint8)
    jj = np.arange(n + 1, dtype=np.int32)
    prev = jj.copy()
    for i in range(1, m + 1):
        v = np.minimum(prev[:-1] + (t != q[i - 1]), prev[1:] + 1)
        a = np.concatenate(([np.int32(i)], v))
        prev = np.minimum.accumulate(a - jj) + jj
    return int(prev.min())
