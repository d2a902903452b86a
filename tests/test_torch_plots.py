"""The port's figures (scrooge_tpu_torch/profiling/plots.py) on the CPU.

Each ported figure is drawn through the module's CLI from CSVs that the
port's own harnesses write on the CPU at a tiny size (the sweep targets,
the scaling harness, the pipeline breakdown and the ASIC model), into a
temporary directory: a PNG must come out, and nothing may be written
into the repository's profile/.
"""

import os

import pytest

pytest.importorskip("matplotlib")
torch = pytest.importorskip("torch")

from scrooge_tpu_torch.profiling import (model, pipeline, plots,  # noqa: E402
                                         scaling, sweep)
from torch_threads import one_intra_op_thread  # noqa: E402,F401

PROFILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "profile")


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """{name: path} of every CSV the figures read, made on the CPU."""
    d = tmp_path_factory.mktemp("csv")
    before = sorted(os.listdir(PROFILE))
    run = ["--device=cpu", "--profile_dir", str(d)]
    assert sweep.main(["device", "simulated:4:300", "--families", "WO,O",
                       "--max_W", "128", "--max_experiments", "2",
                       *run]) == 0
    assert sweep.main(["accuracy", "simulated:16:200", "--max_W", "32",
                       "--max_experiments", "2", "--batch_tile", "128",
                       *run]) == 0
    assert sweep.main(["groundtruth", "simulated:16:200", "--max_W", "32",
                       "--max_experiments", "2", "--batch_tile", "128",
                       "--baseline_pairs", "4", *run]) == 0
    assert sweep.main(["baselines", "simulated:8:200", "--batch_tile",
                       "128", "--baseline_pairs", "4", *run]) == 0
    assert scaling.main(["--device", "cpu", "--per_device", "8",
                         "--read_len", "100", "--reps", "1",
                         "--out", str(d / "scaling.csv")]) == 0
    assert pipeline.main(["--device", "cpu", "--reads", "260",
                          "--read_len", "150", "--genome_len", "20000",
                          "--batch_tile", "128",
                          "--out", str(d / "pipeline.csv")]) == 0
    assert model.main(["sweep", "--out", str(d / "asic.csv")]) == 0
    assert sorted(os.listdir(PROFILE)) == before
    return {
        "wo": d / "simulated_4_300_device_sweep_WO.csv",
        "o": d / "simulated_4_300_device_sweep_O.csv",
        "acc": d / "simulated_16_200_accuracy_sweep_wo.csv",
        "acc_base": d / "simulated_16_200_baselines_accuracy.csv",
        "gt": d / "simulated_16_200_groundtruth_accuracy.csv",
        "gt_base": d / "simulated_16_200_groundtruth_baselines.csv",
        "base": d / "simulated_8_200_baselines.csv",
        "scaling": d / "scaling.csv", "pipeline": d / "pipeline.csv",
        "asic": d / "asic.csv"}


FIGURES = {
    "throughput-W": ["throughput", "--csv={wo}"],
    "throughput-O": ["throughput", "--csv={o}", "--x=O"],
    "accuracy": ["accuracy", "--csv={acc}", "--exact_csv={acc_base}"],
    "roofline": ["roofline", "--csv={wo}", "--read_len=300"],
    "asic": ["asic", "--csv={asic}"],
    "groundtruth": ["groundtruth", "--csv={gt}",
                    "--baselines_csv={gt_base}"],
    "baselines": ["baselines", "--csv={base}"],
    "representative": ["representative", "--csv={wo}",
                       "--baselines_csv={base}"],
    "scaling": ["scaling", "--csv={scaling}"],
    "pipeline": ["pipeline", "--csv={pipeline}"],
}


@pytest.mark.parametrize("figure", list(FIGURES))
def test_figure_is_written(csvs, tmp_path, figure):
    out = tmp_path / f"{figure}.png"
    args = [a.format(**csvs) for a in FIGURES[figure]]
    assert plots.main(args + [f"--out={out}"]) == 0
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(out) > 10_000


def test_roofline_bound_is_the_models():
    """The roofline's bound at the bench shape is model.sol_estimate's,
    at the H100 SXM's data-sheet INT32 rate (132 SMs x 64 x 1980 MHz)."""
    assert model.H100_SXM_INT32_OPS_PER_S == 132 * 64 * 1980e6
    est = model.sol_estimate(64, 64, 33, 10_000, 0.05, 16_384,
                             model.H100_SXM_INT32_OPS_PER_S)
    assert est["bound_by"] == "operations"
    assert est["bound_ms"] == pytest.approx(
        est["int32_ops"] / model.H100_SXM_INT32_OPS_PER_S * 1e3)
