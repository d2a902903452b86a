"""The torch port stands alone: it loads neither JAX nor the JAX package.

The card's machine has no JAX, and the port keeps its own copies of what
it needs from ``scrooge_tpu``, even of modules there that load no JAX.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import os
import sys

import torch
import scrooge_tpu_torch as st
from scrooge_tpu_torch import baselines, bench, cigar, io, wfa
from scrooge_tpu_torch.cli import baseline_cli, options, tests_cli
from scrooge_tpu_torch.ops import _cuda, engine, pack
from scrooge_tpu_torch.parallel import distributed, mesh
from scrooge_tpu_torch.examples import library_example, mesh_example
from scrooge_tpu_torch.profiling import (kernel_time, model, pipeline, plots,
                                         scaling, sweep)
from scrooge_tpu_torch.tools import (cigar_tools, convert, kernel_lab,
                                     window_lab)
from scrooge_tpu_torch.utils.simulate import edge_pairs

for backend in ("auto", "pyref"):
    cfg = st.AlignConfig(backend=backend)
    a = st.align_pairs(["AAAACCCCGGGGTTTT"], ["CCCCGGGGTTTTAAAA"], cfg,
                       device="cpu")
    assert (a[0].edit_distance, a[0].cigar) == (8, "4D12=4I"), a
    g = st.Genome(content="ACGTTGCA" * 40)
    r = st.Read(description="r", content="ACGTTGCA" * 20,
                locations=[st.CandidateLocation(start_in_reference=8)])
    p = st.align_reads(g, [r], cfg, return_packed=True, device="cpu")
    assert p.to_alignments() == [st.Alignment("31=31=31=31=31=5=", 0)], p
m = st.align_pairs(["AAAACCCCGGGGTTTT"] * 3, ["CCCCGGGGTTTTAAAA"] * 3,
                   device=["cpu"] * 2)
assert [(x.edit_distance, x.cigar) for x in m] == [(8, "4D12=4I")] * 3, m
assert len(mesh.align_batch_on_mesh(
    st.AlignConfig(), 8, ["cpu"] * 2, *(pack.pack_2bit(torch.zeros(3, 40, dtype=torch.uint8)),
                           torch.full((3,), 40, dtype=torch.int32)) * 2)) == 2
distributed.initialize()  # no cluster environment: a no-op
assert distributed.align_reads_distributed(g, [r], device="cpu") == \
    st.align_reads(g, [r], device="cpu")
lab = kernel_lab.run_plain("full", 2,
                           *kernel_lab.from_lab_layout(
                               *kernel_lab.lab_inputs(128)))
assert int(lab.total) == 2 * int(lab.wed.sum()) > 0
cfg = st.AlignConfig(W=64, K=16, O=33)
assert engine.window_kernel(cfg) is _cuda.GENASM_WINDOWS1
for k in _cuda.KERNELS:
    assert os.path.isfile(os.path.join(_cuda.CSRC, k.source)), k.source
assert "clock64()" in window_lab.variant_source("clocks")
text, tlen, pattern, plen = edge_pairs(1, 16, 200, 180, cfg.tb_limit)
res = engine.align_batch(cfg, cfg.max_windows(180),
                         pack.pack_2bit(torch.from_numpy(text)),
                         torch.from_numpy(tlen),
                         pack.pack_2bit(torch.from_numpy(pattern)),
                         torch.from_numpy(plen))
assert int((res.failed == engine.FAIL_TB).sum()) > 0
wide = st.AlignConfig(W=320, K=320, O=161)
assert engine.window_kernel(wide) is _cuda.GENASM_WINDOWS_WIDE
a = st.align_pairs(["ACGTTGCA" * 60], ["ACGTTGCA" * 50], wide, device="cpu")
assert a[0].edit_distance == 0, a
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    assert sweep.main(["device", "simulated:2:400", "--device=cpu",
                       "--families=WO", "--max_W=320",
                       "--max_experiments=1", f"--profile_dir={tmp}"]) == 0
    assert scaling.main(["--device", "cpu", "--per_device", "8",
                         "--read_len", "100", "--reps", "1",
                         "--out", os.path.join(tmp, "s.csv")]) == 0
    assert model.main(["sweep", "--out", os.path.join(tmp, "a.csv")]) == 0
    assert pipeline.main(["--device", "cpu", "--reads", "200",
                          "--read_len", "100", "--genome_len", "5000",
                          "--batch_tile", "128",
                          "--out", os.path.join(tmp, "p.csv")]) == 0
# several tiles: the worker thread and the chunked upload and readback
texts = ["ACGTTGCA" * 12] * 300
reads_ = ["ACGTTGCA" * 10] * 300
tiled = st.AlignConfig(batch_tile=128)
for device in ("cpu", ["cpu"] * 2):
    got = st.align_pairs(texts, reads_, tiled, device=device)
    assert [(x.edit_distance, x.cigar) for x in got] == [
        (0, "31=31=18=")] * 300, got[:2]
# uint8 runs (31 < tb_limit <= 63), the second read longer than the first:
# the length sort permutes the pairs and the packed runs are scattered
import numpy as np
w128 = st.AlignConfig(W=128, K=128, O=65)
texts = ["ACGTTGCA" * 30] * 2
reads_ = ["ACGTTGCA" * 15, "ACGTTGCA" * 25]
p, s8 = st.align_pairs(texts, reads_, w128, return_stats=True,
                       return_packed=True, device="cpu")
assert p.to_alignments() == st.align_pairs(texts, reads_, w128,
                                           device="cpu"), p.to_alignments()
assert [a.edit_distance for a in p.to_alignments()] == [0, 0]
assert s8.readback_bytes == 2 * int(np.diff(p.run_offsets).max()), s8
assert library_example.main(["--device", "cpu"]) == 0
assert mesh_example.main(["--device", "cpu"]) == 0
assert "matplotlib" not in sys.modules  # plots and cigar_tools.inspect load it
assert tests_cli.main(["--unit_tests", "--device=cpu"]) == 0
assert baseline_cli.main(["--simulated=2,150", "--threads=128",
                          "--algorithms=genasm_device,exact,wfa",
                          "--accuracy", "--device=cpu"]) == 0
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "scrooge_tpu"))
assert not loaded, loaded
print("ok")
"""

# an import of the JAX package or of JAX by any name; the word boundary
# keeps scrooge_tpu_torch from matching
_FORBIDDEN = re.compile(
    r"^\s*(from|import)\s.*\b(scrooge_tpu|jax|jaxlib)\b(?!_)"
    r"|import_module\(\s*['\"](scrooge_tpu|jax)\b(?!_)"
    r"|__import__\(\s*['\"](scrooge_tpu|jax)\b(?!_)")


def test_port_imports_and_aligns_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "ok"
    assert out.stdout.count("PASSED ") == 5 and "FAILED" not in out.stdout


def test_port_sources_never_import_jax():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "scrooge_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    offenders = []
    for path in paths:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if _FORBIDDEN.search(line):
                    offenders.append(f"{path}:{n}: {line.strip()}")
    assert offenders == []


def test_forbidden_pattern_tells_the_packages_apart():
    assert _FORBIDDEN.search("from scrooge_tpu import pyref")
    assert _FORBIDDEN.search("import scrooge_tpu.native as native")
    assert _FORBIDDEN.search("    from scrooge_tpu.cigar import x")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("importlib.import_module('scrooge_tpu.api')")
    assert not _FORBIDDEN.search("import scrooge_tpu_torch as st")
    assert not _FORBIDDEN.search("from scrooge_tpu_torch.ops import engine")
    assert not _FORBIDDEN.search("# port of scrooge_tpu/api.py")
