"""The port's sweeps on the CPU against the JAX package's.

``python -m scrooge_tpu_torch.profiling.sweep`` with ``--device=cpu``
runs GenASM on the plain torch engine. Its accuracy and ground-truth
targets must write the JAX sweep's files (names, headers and every row,
scores and CIGARs exact) on the same simulated dataset; its throughput
CSVs have the JAX header, rows for the widths asked for (W = 512 among
them) naming the engine that ran, and a failed config makes the exit
code 1. Rates are not compared.
"""

import csv
import os

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from scrooge_tpu.profiling import sweep as jax_sweep  # noqa: E402
from scrooge_tpu_torch.profiling import sweep  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _tree(d):
    return {name: _rows(os.path.join(d, name)) for name in sorted(
        os.listdir(d))}


@pytest.mark.parametrize("target, extra", [
    ("accuracy", ["--cigar"]),
    ("groundtruth", ["--baseline_pairs", "8"]),
])
def test_accuracy_csvs_match_jax_sweep(tmp_path, target, extra):
    args = [target, "simulated:128:300", "--max_W", "32",
            "--max_experiments", "2", "--batch_tile", "128", *extra]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    assert jax_sweep.main(args + ["--profile_dir", str(jdir)]) == 0
    assert sweep.main(args + ["--profile_dir", str(pdir),
                              "--device=cpu"]) == 0
    want, got = _tree(jdir), _tree(pdir)
    assert len(want) == 2 and list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    first = want[next(n for n in want if "accuracy" in n
                      and "baselines" not in n)]
    assert {r[0] for r in first[1:]} == {"16", "32"}
    assert len(first) == 1 + 2 * 128


def test_device_sweep_names_the_engine_that_ran(tmp_path):
    """W = 256 and 512 with and without ET, one row each, on the plain
    engine; the O and batch families write their files too."""
    assert sweep.main(["device", "simulated:4:700", "--device=cpu",
                       "--families", "WO,O,batch", "--max_W", "512",
                       "--max_experiments", "2", "--batch_tile", "128",
                       "--profile_dir", str(tmp_path)]) == 0
    assert sorted(os.listdir(tmp_path)) == [
        f"simulated_4_700_device_sweep_{f}.csv" for f in ("O", "WO",
                                                         "batch")]
    rows = _rows(tmp_path / "simulated_4_700_device_sweep_WO.csv")
    assert rows[0] == jax_sweep.THROUGHPUT_HEADER == sweep.THROUGHPUT_HEADER
    assert [r[:4] + [r[5]] for r in rows[1:]] == [
        [W, O, et, "4", "plain"] for W, O in (("256", "129"), ("512", "257"))
        for et in ("False", "True")]
    assert all(float(r[6]) == float(r[4]) == float(r[7]) > 0
               for r in rows[1:])


def test_failed_config_exits_nonzero(tmp_path, capsys):
    """W=2100 is past the port's limit: the row is not written, the
    failure is on stderr, the exit code is 1."""
    rc = sweep.main(["device", "simulated:2:300", "--device=cpu",
                     "--families", "WO", "--max_W", "2100",
                     "--max_experiments", "1", "--batch_tile", "128",
                     "--profile_dir", str(tmp_path)])
    assert rc == 1
    assert "12-bit run count" in capsys.readouterr().err
    assert _rows(tmp_path / "simulated_2_300_device_sweep_WO.csv") == [
        sweep.THROUGHPUT_HEADER]
    with pytest.raises(SystemExit):
        sweep.main(["device", "simulated:2:300", "--device=cpu",
                    "--families", "kernel"])
