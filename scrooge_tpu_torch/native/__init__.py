"""Native (C++) host helpers: read encoding and CIGAR output.

The port's own copy of the functions of ``scrooge_tpu.native`` it calls.
``cigar_strings.cpp`` is a plain shared library bound with ctypes
(``format_cigars``, ``format_cigars_u8``, ``extract_runs`` of uint16 or
uint8 runs, ``affine_scores``); ``scroogext.cpp`` is a CPython extension
(``encode_pack_strs``, ``format_tokens``, ``tokens_to_runs``,
``scatter_runs``).

Each is built with g++ at first use (``buildcache``) and loaded from
there. A failed build raises: there is no Python fallback. Nothing is
built at import time. Unlike the JAX package's helpers, none returns
None for a missing library or a bad input: each raises.
"""

from __future__ import annotations

import ctypes
import importlib.machinery
import importlib.util
import os
import sysconfig
import threading
from typing import List, Tuple

import numpy as np

from ..buildcache import compile_once

_DIR = os.path.dirname(os.path.abspath(__file__))
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
EXT_NAME = "_scrooge_torch_ext"


class _NativeBuild:
    """One C++ source, compiled once per process and machine type."""

    def __init__(self, source: str, python_ext: bool = False):
        self.source = source
        self.python_ext = python_ext
        self._loaded = None
        self._lock = threading.Lock()

    def flags(self):
        if not self.python_ext:
            return GXX_FLAGS
        return (*GXX_FLAGS, f"-I{_python_include()}")

    def load(self, loader):
        with self._lock:
            if self._loaded is None:
                so, _ = compile_once(os.path.join(_DIR, self.source), "g++",
                                     self.flags(), timeout=300)
                self._loaded = loader(so)
            return self._loaded


def _load_lib(path):
    lib = ctypes.CDLL(path)
    for fn in (lib.format_cigars, lib.format_cigars8):
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    for fn in (lib.extract_runs, lib.extract_runs8):
        fn.restype = None
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
    lib.affine_scores.restype = None
    lib.affine_scores.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p]
    return lib


def _load_ext(path):
    loader = importlib.machinery.ExtensionFileLoader(EXT_NAME, path)
    mod = importlib.util.module_from_spec(
        importlib.util.spec_from_loader(EXT_NAME, loader))
    loader.exec_module(mod)
    return mod


def _python_include() -> str:
    inc = sysconfig.get_paths().get("include")
    if not inc or not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError("Python.h not found; the native extension needs "
                           "the Python development headers")
    return inc


_LIB = _NativeBuild("cigar_strings.cpp")
_EXT = _NativeBuild("scroogext.cpp", python_ext=True)


def get_lib():
    """The ctypes library (cigar_strings.cpp); builds it first."""
    return _LIB.load(_load_lib)


def get_ext():
    """The CPython extension (encode/pack, token decoding); builds it first."""
    return _EXT.load(_load_ext)


def encode_pack_strs(contents, width: int, out=None) -> np.ndarray:
    """ASCII rows -> (len(contents), ceil(width/16)) uint32 words, 2-bit
    codes, char k of a word in bits [2k, 2k+2). ValueError on non-ACGT.
    ``out``: a C-contiguous uint32 array of that shape to write into (a
    pinned staging buffer); it is returned."""
    pw = -(-width // 16)
    if out is None:
        out = np.empty((len(contents), pw), np.uint32)
    elif (out.dtype != np.uint32 or out.shape != (len(contents), pw)
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous uint32 array of "
                         f"shape {(len(contents), pw)}")
    get_ext().encode_pack_into(list(contents), pw, out.ctypes.data)
    return out


def format_tokens(tokens: np.ndarray, totals: np.ndarray) -> List[str]:
    """CIGAR token stream (B, capT) uint8, lane-major -> CIGAR strings."""
    tokens = np.ascontiguousarray(tokens, np.uint8)
    totals = np.ascontiguousarray(totals, np.int32)
    B, capT = tokens.shape
    return get_ext().format_tokens(tokens.ctypes.data, capT, B,
                                   totals.ctypes.data)


def tokens_to_runs(tokens: np.ndarray, totals: np.ndarray, out=None,
                   counts=None) -> Tuple[np.ndarray, np.ndarray]:
    """CIGAR token stream (B, capT) lane-major -> (flat uint16 runs, runs
    per lane); lane b's runs are contiguous, in lane order. ``out`` (uint16)
    and ``counts`` ((B,) int64), both C-contiguous, are written in place
    when given, as scrooge_tpu.native.tokens_to_runs does: a batch decodes
    its lane chunks one after another into one destination."""
    tokens = np.ascontiguousarray(tokens, np.uint8)
    totals = np.ascontiguousarray(totals, np.int32)
    B, capT = tokens.shape
    need = 2 * int(np.minimum(totals, capT).sum())
    if out is None:
        out = np.empty(need, np.uint16)
    elif (out.dtype != np.uint16 or not out.flags.c_contiguous
          or len(out) < need):
        raise ValueError(f"out must be C-contiguous uint16 of at least "
                         f"{need} entries")
    if counts is None:
        counts = np.empty(B, np.int64)
    elif (counts.dtype != np.int64 or counts.shape != (B,)
          or not counts.flags.c_contiguous):
        raise ValueError(f"counts must be C-contiguous int64 of shape {(B,)}")
    n = get_ext().tokens_to_runs(tokens.ctypes.data, capT, B,
                                 totals.ctypes.data, out.ctypes.data,
                                 counts.ctypes.data)
    return out[:n], counts


def extract_runs(entries: np.ndarray, totals: np.ndarray) -> np.ndarray:
    """Compacted (cap, B) runs, uint16 (op << 12 | count) or uint8 (op << 6
    | count, widened on the way) -> one flat uint16 array with lane b's
    valid runs at [cumsum(totals)[b-1], cumsum(totals)[b])."""
    if entries.dtype == np.uint8:
        fn = get_lib().extract_runs8
    elif entries.dtype == np.uint16:
        fn = get_lib().extract_runs
    else:
        raise TypeError(f"extract_runs takes uint8 or uint16 runs, not "
                        f"{entries.dtype}")
    entries = np.ascontiguousarray(entries)
    totals = np.ascontiguousarray(totals, np.int32)
    cap, B = entries.shape
    kept = np.minimum(totals, cap).astype(np.int64)
    offs = np.zeros(B, np.int64)
    np.cumsum(kept[:-1], out=offs[1:])
    out = np.empty(int(kept.sum()), np.uint16)
    fn(entries.ctypes.data, cap, B, totals.ctypes.data, offs.ctypes.data,
       out.ctypes.data)
    return out


def _format(fn, entries: np.ndarray, totals: np.ndarray,
            width: int) -> List[str]:
    """CIGAR strings of (cap, B) runs through ``fn`` (format_cigars or
    format_cigars8), ``width`` the most chars one run takes."""
    totals = np.ascontiguousarray(totals, np.int32)
    cap, B = entries.shape
    stride = max(int(totals.max(initial=0)), 1) * width
    out = np.empty((B, stride), np.uint8)
    lens = np.empty(B, np.int32)
    if fn(entries.ctypes.data, cap, B, totals.ctypes.data, out.ctypes.data,
          stride, lens.ctypes.data) != 0:
        raise RuntimeError("CIGAR formatting overflowed its output rows")
    flat = out.tobytes()
    return [flat[b * stride : b * stride + int(lens[b])].decode("ascii")
            for b in range(B)]


def format_cigars(entries: np.ndarray, totals: np.ndarray) -> List[str]:
    """Compacted (cap, B) uint16 runs -> CIGAR strings."""
    return _format(get_lib().format_cigars,
                   np.ascontiguousarray(entries, np.uint16), totals,
                   5)  # "4095=" is 5 chars


def format_cigars_u8(entries: np.ndarray, totals: np.ndarray) -> List[str]:
    """Compacted (cap, B) uint8 runs (op << 6 | count) -> CIGAR strings."""
    return _format(get_lib().format_cigars8,
                   np.ascontiguousarray(entries, np.uint8), totals,
                   3)  # "63=" is 3 chars


def affine_scores(entries: np.ndarray, totals: np.ndarray, match: int = 2,
                  mismatch: int = 4, gap_open: int = 4,
                  gap_extend: int = 2) -> np.ndarray:
    """Affine-gap score (int64) of each lane of compacted (cap, B) uint16
    runs: +match a matched base, -mismatch a mismatched one, -(gap_open +
    gap_extend * length) a gap run."""
    entries = np.ascontiguousarray(entries, np.uint16)
    totals = np.ascontiguousarray(totals, np.int32)
    cap, B = entries.shape
    out = np.empty(B, np.int64)
    get_lib().affine_scores(entries.ctypes.data, cap, B, totals.ctypes.data,
                            match, mismatch, gap_open, gap_extend,
                            out.ctypes.data)
    return out


def scatter_runs(flat: np.ndarray, offs: np.ndarray, idx: np.ndarray,
                 lens: np.ndarray, out: np.ndarray,
                 out_offs: np.ndarray) -> None:
    """Copy source pair k's ``lens[k]`` uint16 runs at ``flat[offs[k]:]``
    to ``out[out_offs[idx[k]]:]``, for every k, without the GIL: the
    permutation that puts lane-order packed runs into pair order. ``out``
    is a C-contiguous uint16 array; every range must lie inside ``flat``
    and ``out`` (checked first: the copy itself checks nothing)."""
    flat = np.ascontiguousarray(flat, np.uint16)
    offs = np.ascontiguousarray(offs, np.int64)
    idx = np.ascontiguousarray(idx, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    out_offs = np.ascontiguousarray(out_offs, np.int64)
    if out.dtype != np.uint16 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous uint16 array")
    n = len(idx)
    if len(offs) != n or len(lens) != n:
        raise ValueError(f"{n} destinations, {len(offs)} offsets and "
                         f"{len(lens)} lengths")
    if n:
        if (idx.min() < 0 or idx.max() >= len(out_offs) or lens.min() < 0
                or offs.min() < 0 or (offs + lens).max() > len(flat)):
            raise ValueError("scatter_runs: a source range lies outside flat")
        dst = out_offs[idx]
        if dst.min() < 0 or (dst + lens).max() > len(out):
            raise ValueError("scatter_runs: a destination lies outside out")
    get_ext().scatter_runs(flat.ctypes.data, offs.ctypes.data,
                           idx.ctypes.data, n, lens.ctypes.data,
                           out.ctypes.data, out_offs.ctypes.data)
