"""The torch port runs without JAX: the card's machine has none."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import scrooge_tpu_torch as st
a = st.align_pairs(["AAAACCCCGGGGTTTT"], ["CCCCGGGGTTTTAAAA"], device="cpu")
assert (a[0].edit_distance, a[0].cigar) == (8, "4D12=4I"), a
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not loaded, loaded
print("ok")
"""


def test_port_imports_and_aligns_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    pkg = os.path.join(ROOT, "scrooge_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    for n, line in enumerate(f, 1):
                        s = line.strip()
                        if s.startswith(("import jax", "from jax")):
                            offenders.append(f"{path}:{n}")
    assert offenders == []
