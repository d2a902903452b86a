"""Build, bind and count the port's CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain C entry point. It is
compiled with nvcc for ``sm_90a`` on first use (``buildcache``; the
headers under ``csrc/`` are on the include path and in the build key) and
loaded with ctypes. Nothing here runs at import time, so the module
imports on machines without CUDA.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import os
import re
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..buildcache import compile_once

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def source_constant(source: str, name: str) -> int:
    """The value of ``constexpr int <name> = <value>;`` in ``csrc/<source>``,
    for the host code that must agree with a kernel's compile-time
    constant."""
    with open(os.path.join(CSRC, source)) as f:
        found = re.findall(rf"^constexpr int {name} = (\d+);", f.read(), re.M)
    if len(found) != 1:
        raise ValueError(f"{source}: {len(found)} definitions of {name}")
    return int(found[0])


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
    (its template parameters: the word count and early termination,
    engine.kernel_key; the variant). ``counts[key]``
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
                os.path.join(CSRC, self.source), find_nvcc(),
                (*NVCC_FLAGS, "-I", CSRC),
                deps=sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))
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
# and three words; keyed by engine.kernel_key: the words per bitvector,
# NW = ceil(W/64) in 2..3 (the entry point refuses 1, GENASM_WINDOWS1's,
# and 4 and more, GENASM_WINDOWS_WIDE's), with engine.ET_OFF set without
# early termination
GENASM_WINDOWS = CudaKernel(
    "genasm_windows.cu", "genasm_windows_launch",
    [_P, _I64,            # text words, their count
     _P, _P,              # text base chars, text len
     _P, _I64, _P,        # pattern words, words per pattern row, pattern len
     _I, _I, _I, _I, _I,  # B, W, K, O, max_windows
     _P, _P,              # R scratch, forefront scratch
     _P, _P, _P, _P,      # ed, failed, entries, counts
     _P])                 # cudaStream_t

# the window kernel for one word (W <= 64): a warp a pair, R and the
# forefront in shared memory; keyed by engine.kernel_key, whose NW must be
# 1. No scratch: its one buffer is the two row counters it adds to.
GENASM_WINDOWS1 = CudaKernel(
    "genasm_windows1.cu", "genasm_windows1_launch",
    [_P, _I64,            # text words, their count
     _P, _P,              # text base chars, text len
     _P, _I64, _P,        # pattern words, words per pattern row, pattern len
     _I, _I, _I, _I, _I,  # B, W, K, O, max_windows
     _P,                  # row counters (2 int64: row slots, row work)
     _P, _P, _P, _P,      # ed, failed, entries, counts
     _P])                 # cudaStream_t

# the counterpart of engine_xla._window_step / _align_scan, which the JAX
# package runs for W > 256, and of slab_step_kernel at four words: four
# to 32 words, a warp a pair in groups of G threads; keyed by
# engine.kernel_key, NW = ceil(W/64) in 4..32 (the entry point refuses
# fewer)
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

# replaces, on a card, ops/tokens.lane_tokens_plain (the JAX package's
# tokens.compact_tokenize + compact_tokens): a tile's runs to lane-major
# tokens, a warp a lane; key 0, its one instantiation
GENASM_TOKENS = CudaKernel(
    "genasm_tokens.cu", "genasm_tokens_launch",
    [_P, _P,              # entries (wcap, ne, B), counts (wcap, B)
     _I, _I, _I, _I64,    # wcap, ne, B, capB
     _P, _P,              # out (B, capB), lane_tot (B,)
     _P])                 # cudaStream_t

KERNELS = (GENASM_WINDOWS1, GENASM_WINDOWS, GENASM_WINDOWS_WIDE,
           GENASM_FILL_LAB, GENASM_TOKENS)


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
