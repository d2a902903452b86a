"""Build, bind and count the port's CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain C entry point. It is
compiled with nvcc for ``sm_90a`` into ``scrooge_tpu_torch/_build/`` on
first use, under a name keyed by a hash of its source and flags, and
loaded with ctypes. Nothing here runs at import time, so the module
imports on machines without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

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
    """One kernel: its source, its C entry point, and its launch count.

    ``launches`` goes up by one each time ``launch`` starts the kernel,
    and nowhere else, so a caller can show that a run went through it.
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def so_path(self) -> str:
        with open(os.path.join(CSRC, self.source), "rb") as f:
            key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"{stem}-{key.hexdigest()[:16]}.so")

    def build(self):
        """Compile (unless built already) and bind; returns the C function.
        Raises RuntimeError when nvcc is missing or the build fails."""
        with self._lock:
            if self._fn is not None:
                return self._fn
            so = self.so_path()
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                       os.path.join(CSRC, self.source)]
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=900)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {self.source} "
                        f"(exit {proc.returncode}):\n{self.build_log}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            fn = getattr(lib, self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
            return fn

    def launch(self, *args) -> None:
        """Launch on the stream passed in ``args``; raises when the launch
        status (cudaGetLastError right after it) is not cudaSuccess."""
        rc = self.build()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{rc}")
        self.launches += 1


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

# replaces engine_pallas.slab_step_kernel (_multi_window_kernel)
GENASM_WINDOWS = CudaKernel(
    "genasm_windows.cu", "genasm_windows_launch",
    [_P, _P, _P,          # text words, text base chars, text len
     _P, _I64, _P,        # pattern words, words per pattern row, pattern len
     _I, _I, _I, _I, _I,  # B, W, K, O, max_windows
     _P, _P,              # R scratch, forefront scratch
     _P, _P, _P, _P,      # ed, failed, entries, counts
     _P])                 # cudaStream_t
