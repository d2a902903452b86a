"""Build, bind and count the port's CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain C entry point. It is
compiled with nvcc for ``sm_90a`` on first use (``buildcache``) and loaded
with ctypes. Nothing here runs at import time, so the module
imports on machines without CUDA.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..buildcache import compile_once

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then the toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in CUDA_HOME, PATH and "
                       "/usr/local/cuda/bin)")


class CudaKernel:
    """One kernel source: its C entry point and its launch counts.

    The entry point's first argument selects the kernel's instantiation
    (a template parameter: the word count, the variant). ``counts[key]``
    goes up by one each time ``launch`` starts that instantiation, and
    nowhere else, so a caller can show that a run went through it. The
    count is taken under the kernel's lock: shards of a mesh launch from
    threads of their own.
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = [ctypes.c_int, *argtypes]
        self.counts = collections.Counter()
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def build(self):
        """Compile (unless built already) and bind; returns the C function.
        Raises RuntimeError when nvcc is missing or the build fails."""
        with self._lock:
            if self._fn is not None:
                return self._fn
            so, self.build_log = compile_once(
                os.path.join(CSRC, self.source), find_nvcc(), NVCC_FLAGS)
            lib = ctypes.CDLL(so)
            fn = getattr(lib, self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
            return fn

    def launch(self, key: int, *args) -> None:
        """Launch instantiation ``key`` on the stream passed in ``args``;
        raises when the entry point refuses the arguments (-1) or the
        launch status (cudaGetLastError right after it) is not
        cudaSuccess."""
        rc = self.build()(key, *args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}({key}) launch failed: "
                               + ("arguments refused" if rc == -1
                                  else f"CUDA error {rc}"))
        with self._lock:
            self.counts[key] += 1


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

# replaces engine_pallas.slab_step_kernel (_multi_window_kernel) for two
# to four words; keyed by the words per bitvector, NW = ceil(W/64) in
# 2..4 (the entry point refuses 1: GENASM_WINDOWS1 takes one word)
GENASM_WINDOWS = CudaKernel(
    "genasm_windows.cu", "genasm_windows_launch",
    [_P, _I64,            # text words, their count
     _P, _P,              # text base chars, text len
     _P, _I64, _P,        # pattern words, words per pattern row, pattern len
     _I, _I, _I, _I, _I,  # B, W, K, O, max_windows
     _P, _P,              # R scratch, forefront scratch
     _P, _P, _P, _P,      # ed, failed, entries, counts
     _P])                 # cudaStream_t

# the window kernel for one word (W <= 64): the forefront in registers;
# keyed by NW, which must be 1. No forefront scratch.
GENASM_WINDOWS1 = CudaKernel(
    "genasm_windows1.cu", "genasm_windows1_launch",
    [_P, _I64,            # text words, their count
     _P, _P,              # text base chars, text len
     _P, _I64, _P,        # pattern words, words per pattern row, pattern len
     _I, _I, _I, _I, _I,  # B, W, K, O, max_windows
     _P,                  # R scratch
     _P, _P, _P, _P,      # ed, failed, entries, counts
     _P])                 # cudaStream_t

# the counterpart of engine_xla._window_step / _align_scan, which the JAX
# package runs for W > 256: five to 32 words, a group of G threads a
# pair; keyed by NW = ceil(W/64) in 5..32 (the entry point refuses fewer)
GENASM_WINDOWS_WIDE = CudaKernel(
    "genasm_windows_wide.cu", "genasm_windows_wide_launch",
    [_P, _I64,            # text words, their count
     _P, _P,              # text base chars, text len
     _P, _I64, _P,        # pattern words, words per pattern row, pattern len
     _I, _I, _I, _I, _I,  # B, W, K, O, max_windows
     _P, _P,              # R scratch, forefront scratch
     _P, _P, _P, _P,      # ed, failed, entries, counts
     _P])                 # cudaStream_t

# replaces tools/kernel_lab.py:run (fill_kernel); keyed by the variant,
# 0 full, 1 nostore, 2 noff. A group of threads a lane; no forefront
# scratch.
GENASM_FILL_LAB = CudaKernel(
    "genasm_fill_lab.cu", "genasm_fill_lab_launch",
    [_I, _P, _P, _P, _I,  # nwin, m, n, pmi, B
     _P,                  # R scratch (full only)
     _P, _P,              # wed, per-lane sum over windows
     _P])                 # cudaStream_t

KERNELS = (GENASM_WINDOWS1, GENASM_WINDOWS, GENASM_WINDOWS_WIDE,
           GENASM_FILL_LAB)


def build_all(kernels=KERNELS):
    """Build every kernel at once, one nvcc each, all started together;
    returns {source: seconds until built}. Raises the first failure."""
    t0 = time.perf_counter()

    def one(k):
        k.build()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        futures = [(k.source, pool.submit(one, k)) for k in kernels]
        return {src: f.result() for src, f in futures}
