"""The port's analytical models (scrooge_tpu_torch/profiling/model.py).

The ASIC half must print and write exactly what the JAX module does. The
H100 bound is checked on small CPU cases against counts reckoned by hand:
the plain engine's work counters on identical pairs (each window stops at
row 0, so a window of n text chars is n+1 cells), then window_bound,
r_floor and fill_bound on them.
"""

import contextlib
import csv
import io
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from scrooge_tpu.profiling import model as jax_model  # noqa: E402
import scrooge_tpu_torch as st  # noqa: E402
from scrooge_tpu_torch.ops import engine, pack  # noqa: E402
from scrooge_tpu_torch.profiling import model  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stdout(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _cli(module, *argv):
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_improvements_lines_equal_jax():
    want, got = io.StringIO(), io.StringIO()
    jax_model.print_improvements(out=want)
    model.print_improvements(out=got)
    assert got.getvalue() == want.getvalue()
    assert "Area Improvement: " in got.getvalue()
    cli = _cli("scrooge_tpu_torch.profiling.model", "improvements")
    assert cli.splitlines() == _cli("scrooge_tpu.profiling.model",
                                    "improvements").splitlines()
    assert cli.splitlines() == want.getvalue().splitlines()


def test_sweep_rows_equal_jax(tmp_path):
    paths = {}
    for name, main in (("jax", jax_model.main), ("port", model.main)):
        paths[name] = tmp_path / f"{name}.csv"
        _stdout(main, ["sweep", f"--out={paths[name]}"])
    rows = {k: list(csv.reader(open(p))) for k, p in paths.items()}
    assert rows["port"] == rows["jax"]
    assert len(rows["port"]) == 1 + 64 * 4
    assert model.sweep_rows() == jax_model.sweep_rows()
    assert model.expected_rows(64, 33, 0.05, 1) == jax_model.expected_rows(
        64, 33, 0.05, 1)


@pytest.fixture(scope="module")
def identical_pairs():
    """Two lanes at 64/64/33 whose read is its text's prefix: 100 of 100
    chars and 40 of 100. Windows consume 31 chars each; lane 0 has 100,
    69, 38 and 7 text chars left at its four windows, 65+65+39+8 = 177
    cells; lane 1's read ends in its second window, 65+65 = 130 cells; a
    traceback step a read char (100 and 40); one '=' run a window (4
    and 2). A window fills one row, so the cells of one row over the
    windows are the cells filled."""
    cfg = st.AlignConfig(W=64, K=64, O=33)
    text = np.random.default_rng(0).integers(0, 4, (2, 100), dtype=np.uint8)
    tw = pack.pack_2bit(torch.from_numpy(text))
    tlen = torch.tensor([100, 100], dtype=torch.int32)
    plen = torch.tensor([100, 40], dtype=torch.int32)
    base = torch.arange(2, dtype=torch.int64) * (tw.shape[1] * 16)
    args = (tw, base, tlen, tw.clone(), plen)
    res = engine.align_windows(cfg, 8, *args)
    return cfg, args, res


def test_plain_work_counters_are_the_hand_counts(identical_pairs):
    _, _, res = identical_pairs
    assert res.work.tolist() == [[177, 130], [100, 40], [177, 130]]
    assert res.counts.sum(0).tolist() == [4, 2]
    assert res.edit_distance.tolist() == [0, 0]


def test_window_bound_by_hand(identical_pairs):
    cfg, args, res = identical_pairs
    # 307 cells x 8 INT32 instructions (one word) + 140 steps x 12
    ops = 307 * 8 + 140 * 12
    # read chars 2 bits each in and out (140 // 2), 16 B of lengths and
    # bases a lane, a u16 per run, a window count a window (maxw 8) and
    # 24 B of results a lane
    nbytes = 140 // 2 + 16 * 2 + 2 * 6 + 4 * 8 * 2 + 24 * 2
    ms, by, detail = model.window_bound(cfg, 8, args, res, ops * 1e3)
    assert detail == dict(cells=307, tb_steps=140, int32_ops=ops,
                          bytes=nbytes)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    ms, by, _ = model.window_bound(cfg, 8, args, res, 1e30)
    assert (ms, by) == (pytest.approx(nbytes / model.HBM_BYTES_PER_S * 1e3),
                        "bytes")
    # 307 cells are 4 whole rows of 65; one stored word a column (O-1 =
    # 32 < 64), 32 columns of 8 bytes a row
    assert model.r_floor(cfg, res) == (4 * 32 * 8, pytest.approx(
        4 * 32 * 8 / model.HBM_BYTES_PER_S * 1e3))


@pytest.mark.parametrize("variant, ops, nbytes", [
    # 64 windows; lane 0 (n = 64, wed 0): 64 row-0 cells of 4; lane 1
    # (n = 10, wed 2): 10 columns of 4 + 2 rows x 8
    ("nostore", 64 * (64 * 4 + 10 * (4 + 2 * 8)), 64 * 2 * 8 + 2 * 20),
    # and R's rows 0..wed, 32 columns of 8 bytes: 1 + 3 rows
    ("full", 64 * (64 * 4 + 10 * (4 + 2 * 8)), 64 * 2 * 8 + 2 * 20
     + 4 * 32 * 8),
    # the row above is 0: rows d >= 1 take nothing
    ("noff", 64 * (64 * 4 + 10 * 4), 64 * 2 * 8 + 2 * 20),
])
def test_fill_bound_by_hand(variant, ops, nbytes):
    wed = torch.tensor([0, 2], dtype=torch.int32)
    n = torch.tensor([64, 10], dtype=torch.int32)
    assert model.fill_bound(variant, wed, n, ops * 1e3) == (
        pytest.approx(1.0), "operations")
    assert model.fill_bound(variant, wed, n, 1e30) == (
        pytest.approx(nbytes / model.HBM_BYTES_PER_S * 1e3), "bytes")


def test_sol_counted_on_the_cpu_is_window_bound():
    """sol's counted form on a tiny simulated batch: the plain engine's
    counters, at least a cell a read char, and the expected form within
    a factor of a few of it."""
    rate = 1e12
    got = model.sol_counted(64, 64, 33, 300, 0.05, 8, rate, device="cpu")
    assert got["cells"] >= 8 * 250 and got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(got["int32_ops"] / rate * 1e3)
    est = model.sol_estimate(64, 64, 33, 300, 0.05, 8, rate)
    assert 0.2 < est["bound_ms"] / got["bound_ms"] < 5
    out = _stdout(model.main, ["sol", "--int32_tops=1", "--batch=8",
                               "--read_len=300", "--counted",
                               "--device=cpu"])
    assert "expected bound_ms: " in out and "counted bound_ms: " in out


def test_window_bound_without_early_termination_by_hand(identical_pairs):
    """Without early termination every window fills its 65 rows: 65 x 307
    cells, from the ET-on result's count of one row's cells as from the
    ET-off result's own counters; R's floor counts them as 307 whole
    rows of 65 cells."""
    cfg, args, res = identical_pairs
    off = cfg.__class__(W=64, K=64, O=33, early_termination=False)
    res_off = engine.align_windows(off, 8, *args)
    assert res_off.work.tolist() == [[65 * 177, 65 * 130], [100, 40],
                                     [177, 130]]
    ops = 65 * 307 * 8 + 140 * 12
    for r in (res, res_off):
        ms, by, detail = model.window_bound(off, 8, args, r, ops * 1e3)
        assert (detail["cells"], detail["int32_ops"]) == (65 * 307, ops)
        assert (ms, by) == (pytest.approx(1.0), "operations")
        assert model.r_floor(off, r)[0] == 307 * 32 * 8


def test_expected_rows_follow_early_termination():
    """K+1 rows a window without early termination; with it the
    binomial tail, capped at K+1 (W+1 where K is not given, as the JAX
    module has it)."""
    assert model.expected_rows(64, 33, 0.05, 1, K=64,
                               early_termination=False) == 65
    assert model.expected_rows(512, 257, 0.05, 1,
                               early_termination=False) == 513
    assert model.expected_rows(64, 33, 0.05, 1, K=64) == \
        model.expected_rows(64, 33, 0.05, 1)
    assert model.expected_rows(64, 33, 0.5, 16384, K=8) == 9
    rate = 1e12
    on = model.sol_estimate(64, 64, 33, 10_000, 0.05, 16_384, rate)
    off = model.sol_estimate(64, 64, 33, 10_000, 0.05, 16_384, rate,
                             early_termination=False)
    assert off["rows_per_window"] == 65 < 65 * on["rows_per_window"]
    assert off["cells"] == pytest.approx(
        on["cells"] * 65 / on["rows_per_window"], rel=1e-6)
    assert off["bound_ms"] > 10 * on["bound_ms"]
