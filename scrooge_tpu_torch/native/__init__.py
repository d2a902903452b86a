"""Native (C++) host helpers: read encoding and CIGAR output.

The port's own copy of the five functions of ``scrooge_tpu.native`` it
calls. ``cigar_strings.cpp`` is a plain shared library bound with ctypes
(``format_cigars``, ``extract_runs``); ``scroogext.cpp`` is a CPython
extension (``encode_pack_strs``, ``format_tokens``, ``tokens_to_runs``).

Each is built with g++ at first use (``buildcache``) and loaded from
there. A failed build raises: there is no Python fallback. Nothing is
built at import time.
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
    lib.format_cigars.restype = ctypes.c_int
    lib.format_cigars.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.extract_runs.restype = None
    lib.extract_runs.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
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
    """The ctypes library (format_cigars, extract_runs); builds it first."""
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
    """Compacted (cap, B) uint16 runs -> one flat uint16 array with lane
    b's valid runs at [cumsum(totals)[b-1], cumsum(totals)[b])."""
    entries = np.ascontiguousarray(entries, np.uint16)
    totals = np.ascontiguousarray(totals, np.int32)
    cap, B = entries.shape
    kept = np.minimum(totals, cap).astype(np.int64)
    offs = np.zeros(B, np.int64)
    np.cumsum(kept[:-1], out=offs[1:])
    out = np.empty(int(kept.sum()), np.uint16)
    get_lib().extract_runs(entries.ctypes.data, cap, B, totals.ctypes.data,
                           offs.ctypes.data, out.ctypes.data)
    return out


def format_cigars(entries: np.ndarray, totals: np.ndarray) -> List[str]:
    """Compacted (cap, B) uint16 runs -> CIGAR strings."""
    entries = np.ascontiguousarray(entries, np.uint16)
    totals = np.ascontiguousarray(totals, np.int32)
    cap, B = entries.shape
    stride = max(int(totals.max(initial=0)), 1) * 5  # "4095=" is 5 chars
    out = np.empty((B, stride), np.uint8)
    lens = np.empty(B, np.int32)
    rc = get_lib().format_cigars(entries.ctypes.data, cap, B,
                                 totals.ctypes.data, out.ctypes.data, stride,
                                 lens.ctypes.data)
    if rc != 0:
        raise RuntimeError("format_cigars overflowed its output rows")
    flat = out.tobytes()
    return [flat[b * stride : b * stride + int(lens[b])].decode("ascii")
            for b in range(B)]
