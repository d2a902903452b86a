"""The port's examples (scrooge_tpu_torch/examples/) run with --device cpu.

library_example must print, for the window engine on the device, the
alignments the JAX package's examples/library_example.py prints for its
XLA engine, and the scalar oracle must agree; mesh_example must run its
automatic and explicit meshes on CPU shards. Without a card, the default
``--device cuda`` fails rather than fall back to the CPU.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*argv, env=None):
    return subprocess.run([sys.executable, *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})))


def test_library_example_on_cpu_prints_the_jax_example_lines():
    pytest.importorskip("jax")
    port = _run("-m", "scrooge_tpu_torch.examples.library_example",
                "--device", "cpu")
    assert port.returncode == 0, port.stderr
    want = _run("examples/library_example.py", env={"JAX_PLATFORMS": "cpu"})
    assert want.returncode == 0, want.stderr
    lines = port.stdout.splitlines()
    assert len(lines) == 2 * 7
    blocks = {ln[1: ln.index("]")]: [] for ln in lines if ln.startswith("[")}
    tag = None
    for ln in lines:
        if ln.startswith("["):
            tag = ln[1: ln.index("]")]
        blocks[tag].append(ln.replace(f"[{tag}] ", ""))
    xla = [ln.replace("[xla] ", "") for ln in want.stdout.splitlines()[:7]]
    assert blocks["auto"] == xla
    assert blocks["pyref"] == xla
    assert "  CCCCGGGGTTTTAAAA: edit_distance=8 cigar=4D12=4I" in xla


@pytest.mark.parametrize("shards", [2, 3])
def test_mesh_example_on_cpu(shards):
    out = _run("-m", "scrooge_tpu_torch.examples.mesh_example", "--device",
               "cpu", "--shards", str(shards))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("device='cpu', 256 pairs") and \
        lines[0].endswith("equal to the CPU's: True")
    per = [512 // shards + (k < 512 % shards) for k in range(shards)]
    assert f"in {shards} shards" in lines[1]
    assert f"lanes a shard {per}" in lines[1]
    assert lines[1].endswith("failed lanes 0")


@pytest.mark.parametrize("example", ["library_example", "mesh_example"])
def test_default_device_needs_a_card(example):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device runs")
    out = _run("-m", f"scrooge_tpu_torch.examples.{example}")
    assert out.returncode != 0
    assert "is_available() is False" in out.stderr
