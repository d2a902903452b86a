"""The port's build cache (``scrooge_tpu_torch/buildcache.py``).

A library is built once per content and flags; the compiler's output is
kept beside it, so a later call that finds the library built still
returns what the compiler said (the smoke run reads registers and spills
from it). Built with g++ into a temporary directory; skips where g++ is
absent.
"""

import os
import shutil

import pytest

from scrooge_tpu_torch import buildcache

# an unused variable: g++ -Wall says so, which makes the output non-empty
SOURCE = "int f(void) { int unused; return 1; }\n"
FLAGS = ("-shared", "-fPIC", "-Wall")


@pytest.fixture
def gxx(tmp_path, monkeypatch):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    monkeypatch.setattr(buildcache, "BUILD_DIR", str(tmp_path / "build"))
    (tmp_path / "k.cpp").write_text(SOURCE)
    return gxx, str(tmp_path / "k.cpp")


def test_cached_build_returns_the_compilers_output(gxx):
    compiler, src = gxx
    so, log = buildcache.compile_once(src, compiler, FLAGS)
    assert os.path.exists(so) and "unused" in log
    again, log2 = buildcache.compile_once(src, compiler, FLAGS)
    assert (again, log2) == (so, log)
    os.remove(so + ".log")  # a library built before the log was kept
    assert buildcache.compile_once(src, compiler, FLAGS) == (so, "")


def test_new_flags_build_anew(gxx):
    compiler, src = gxx
    so, _ = buildcache.compile_once(src, compiler, FLAGS)
    other, log = buildcache.compile_once(src, compiler, FLAGS[:2])
    assert other != so and os.path.exists(other) and "unused" not in log


def test_a_changed_header_builds_anew(gxx, tmp_path):
    """A header the source includes is part of the key: the same source
    and flags with an edited header build a new library."""
    compiler, src = gxx
    header = tmp_path / "k.h"
    header.write_text("// one\n")
    so, _ = buildcache.compile_once(src, compiler, FLAGS, deps=[str(header)])
    again, _ = buildcache.compile_once(src, compiler, FLAGS,
                                       deps=[str(header)])
    assert again == so
    header.write_text("// two\n")
    other, _ = buildcache.compile_once(src, compiler, FLAGS,
                                       deps=[str(header)])
    assert other != so and os.path.exists(other)
