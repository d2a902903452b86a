"""Compile a source file into a shared library, once per content and flags.

The port's CUDA kernels (nvcc) and native host helpers (g++) are built at
first use into ``scrooge_tpu_torch/_build/``, under a name keyed by a hash
of the source, the compiler flags and the machine type, so an edit or a
new flag builds anew and a checkout never loads a stale library. Nothing
is built at import time. A source's headers are passed as ``deps`` and
hashed with it.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from typing import Sequence, Tuple

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")


def compile_once(source: str, compiler: str, flags: Sequence[str],
                 timeout: int = 900,
                 deps: Sequence[str] = ()) -> Tuple[str, str]:
    """(path of the built library, the compiler's output). ``deps`` are
    the files the source includes, hashed with it. The output is kept
    beside the library (``.log``) and read back when the library was
    built before, empty where that file is missing. Raises RuntimeError
    when the compiler cannot be run or fails; there is no fallback."""
    h = hashlib.sha256()
    for path in (source, *deps):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join((*flags, platform.machine())).encode())
    key = h.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(BUILD_DIR, f"{stem}-{key}.so")
    if os.path.exists(so):
        try:
            with open(so + ".log") as f:
                return so, f.read()
        except OSError:
            return so, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, source],
                              capture_output=True, text=True,
                              timeout=timeout)
    except OSError as e:
        raise RuntimeError(f"{compiler} could not be run for {source}: "
                           f"{e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed on {source} (exit "
                           f"{proc.returncode}):\n{log}")
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", so + ".log")
    os.replace(tmp, so)
    return so, log
