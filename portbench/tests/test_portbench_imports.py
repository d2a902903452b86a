"""Nothing under portbench/ imports JAX or the JAX package, by whole
top-level names: scrooge_tpu_torch is allowed, scrooge_tpu is not."""

import ast
import os
import sys

from portbench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    seen = {}
    for dirpath, _, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                for top in _top_level_imports(path):
                    seen.setdefault(top, []).append(path)
    assert "scrooge_tpu_torch" in seen  # the scan sees the program
    assert not set(seen) & set(run.FORBIDDEN), {
        k: v for k, v in seen.items() if k in run.FORBIDDEN}


def test_loaded_module_check_compares_whole_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "scrooge_tpu_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "scrooge_tpu.api", sys)
    assert run.forbidden_modules() == ["scrooge_tpu"]
