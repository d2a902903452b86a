"""The fill-lab kernel's lane-group code on the host, under sanitizers.

``tests/fill_lab_host.cpp`` includes ``csrc/genasm_fill_lab.cu`` itself
(not a copy) and stands in for the card's shuffles and ballots: the 32
threads of a warp (32/G lane groups of G) run in lockstep over an
array. It is built with g++ under AddressSanitizer and UBSan into
``scrooge_tpu_torch/_build/`` and run on the (m, n) cases of
``kernel_lab.MN_CASES`` at 128 lanes; every lane's wed and its sum over
windows must equal ``run_plain``'s, and in full the rows of R that both
must store (``kernel_lab.r_mismatches``), also on a ragged batch (126
lanes).
The window lab's source variants (other group sizes and block widths)
run on the ragged batch. Skips where g++ or the sanitizer runtime is
absent.
"""

import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scrooge_tpu_torch.buildcache import BUILD_DIR  # noqa: E402
from scrooge_tpu_torch.ops import _cuda  # noqa: E402
from scrooge_tpu_torch.tools import kernel_lab, window_lab  # noqa: E402

HARNESS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fill_lab_host.cpp")
FLAGS = ("-std=c++17", "-O1", "-g", "-Wall", "-Wextra", "-Werror",
         "-Wno-unknown-pragmas", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all", "-fno-omit-frame-pointer")
SOURCE_VARIANTS = window_lab.SOURCES["genasm_fill_lab.cu"][2]
LANES, NWIN = 128, 3


def _build(gxx: str, variant: str) -> str:
    """The harness around the kernel source with ``variant``'s edits,
    built once per content under BUILD_DIR/fill_lab_host/."""
    src = window_lab.variant_source(variant, "genasm_fill_lab.cu")
    with open(HARNESS) as f:
        harness = f.read()
    key = hashlib.sha256("\0".join((src, harness, *FLAGS)).encode()
                         ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, "fill_lab_host", key)
    exe = os.path.join(out, "fill_lab_host")
    if os.path.exists(exe):
        return exe
    os.makedirs(out, exist_ok=True)
    # concurrent builds of one key each write their own files and
    # replace the shared ones whole
    tmp = f".{os.getpid()}.tmp"
    cu = os.path.join(out, _cuda.GENASM_FILL_LAB.source)
    with open(cu + tmp, "w") as f:
        f.write(src)
    os.replace(cu + tmp, cu)
    proc = subprocess.run([gxx, *FLAGS, "-I", out, HARNESS, "-o",
                           exe + tmp], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    os.replace(exe + tmp, exe)
    return exe


@pytest.fixture(scope="module")
def gxx(tmp_path_factory):
    """g++ that links and runs a sanitized program, or a skip."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("sanitizer_probe")
    (d / "probe.cpp").write_text("int main() { return 0; }\n")
    proc = subprocess.run([gxx, "-fsanitize=address,undefined", "-o",
                           str(d / "probe"), str(d / "probe.cpp")],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0 or subprocess.run(
            [str(d / "probe")], capture_output=True, timeout=60).returncode:
        pytest.skip("the AddressSanitizer / UBSan runtime is not available: "
                    + proc.stderr.strip()[-200:])
    return gxx


@pytest.fixture(scope="module")
def harness(gxx):
    built = {}

    def get(variant):
        if variant not in built:
            built[variant] = _build(gxx, variant)
        return built[variant]
    return get


def _run(exe, variant, m, n, pmi):
    B = int(m.shape[0])
    head = np.array([kernel_lab.VARIANTS.index(variant), NWIN, B], np.int32)
    stdin = b"".join(np.ascontiguousarray(x).tobytes()
                     for x in (head, m.numpy(), n.numpy(), pmi.numpy()))
    proc = subprocess.run([exe], input=stdin, capture_output=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr.decode(errors="replace")[-4000:]
    words = (kernel_lab.K + 1) * kernel_lab.COLS * B
    assert len(proc.stdout) == 12 * B + (8 * words if variant == "full"
                                         else 0)
    out = np.frombuffer(proc.stdout, np.uint8)
    wed = torch.from_numpy(out[: 4 * B].view(np.int32).copy())
    acc = torch.from_numpy(out[4 * B: 12 * B].view(np.int64).copy())
    R = (torch.from_numpy(out[12 * B:].view(np.int64).copy()).view(
        kernel_lab.K + 1, kernel_lab.COLS, B) if variant == "full" else None)
    return kernel_lab.LabResult(acc.sum(), wed, R), acc


def _check(exe, variant, mn, B=LANES):
    m, n, pmi = kernel_lab.from_lab_layout(
        *kernel_lab.lab_inputs(LANES, 0, *mn))
    port = m[:B].contiguous(), n[:B].contiguous(), pmi[:, :B].contiguous()
    got, acc = _run(exe, variant, *port)
    want = kernel_lab.run_plain(variant, NWIN, *port)
    assert torch.equal(got.wed, want.wed)
    assert torch.equal(acc, NWIN * want.wed.long())
    assert int(got.total) == int(want.total)
    if variant == "full":
        assert kernel_lab.r_mismatches(got, want) == 0


@pytest.mark.parametrize("mn", kernel_lab.MN_CASES,
                         ids=lambda mn: "m{}-n{}".format(*mn))
@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
def test_lane_group_matches_plain(harness, variant, mn):
    _check(harness("full"), variant, mn)


@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
def test_lane_group_ragged_batch(harness, variant):
    """126 lanes: the last warp's last lanes lie past the batch; they
    compute on a clamped lane and write nothing."""
    _check(harness("full"), variant, (None, None), B=LANES - 2)


@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
@pytest.mark.parametrize("source", [v for v in SOURCE_VARIANTS
                                    if v != "full"])
def test_source_variant_matches_plain(harness, source, variant):
    _check(harness(source), variant, (None, None), B=LANES - 2)
