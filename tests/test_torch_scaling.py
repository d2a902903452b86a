"""The port's scaling harness (scrooge_tpu_torch/profiling/scaling.py) on
the CPU: the shape of its CSVs and the truth of their card, cards,
shards and processes columns. No efficiency is asserted: on one shared
host it measures core contention, not the software.
"""

import csv

import pytest

torch = pytest.importorskip("torch")

from scrooge_tpu_torch.parallel import mesh as M  # noqa: E402
from scrooge_tpu_torch.profiling import scaling  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

JAX_MESH_COLUMNS = ["platform", "engine", "devices", "batch", "read_len",
                    "aligns_per_second", "weak_scaling_efficiency"]
JAX_DIST_COLUMNS = ["platform", "processes", "per_process", "total_pairs",
                    "read_len", "aligns_per_second", "slowest_process_s",
                    "cpu_s", "cpu_s_max", "weak_scaling_efficiency",
                    "cpu_normalized_efficiency"]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_distributed_rows(tmp_path):
    out = tmp_path / "dist.csv"
    assert scaling.main(["--device", "cpu", "--distributed", "2",
                         "--per_process", "128", "--read_len", "150",
                         "--out", str(out)]) == 0
    rows = _rows(out)
    assert set(JAX_DIST_COLUMNS + ["card", "cards"]) == set(rows[0])
    assert [int(r["processes"]) for r in rows] == [1, 2]
    assert [int(r["total_pairs"]) for r in rows] == [128, 256]
    for r in rows:
        assert (r["platform"], r["card"], r["cards"]) == ("cpu", "cpu", "1")
        assert float(r["aligns_per_second"]) > 0
        assert float(r["cpu_s"]) > 0 and float(r["slowest_process_s"]) > 0


def test_mesh_rows(tmp_path):
    out = tmp_path / "mesh.csv"
    assert scaling.main(["--device", "cpu", "--shards", "3",
                         "--per_device", "32", "--read_len", "120",
                         "--reps", "1", "--out", str(out)]) == 0
    rows = _rows(out)
    assert list(rows[0]) == JAX_MESH_COLUMNS + ["card", "cards", "shards"]
    assert [(int(r["shards"]), int(r["devices"]), int(r["batch"]))
            for r in rows] == [(1, 1, 32), (2, 2, 64), (3, 3, 96)]
    for r in rows:
        assert (r["card"], r["cards"], r["engine"]) == ("cpu", "1", "plain")
        assert float(r["aligns_per_second"]) > 0


def test_device_time_rows(tmp_path):
    out = tmp_path / "dt.csv"
    assert scaling.main(["--device", "cpu", "--device_time",
                         "--per_device", "32", "--read_len", "120",
                         "--reps", "1", "--out", str(out)]) == 0
    rows = _rows(out)
    assert [int(r["shards"]) for r in rows] == [1, 2]
    for r in rows:
        assert r["timer"] == "process_time" and r["cards"] == "1"
        assert float(r["device_s"]) > 0 and float(r["work_ratio"]) > 0
        assert float(r["per_device_s"]) == pytest.approx(
            float(r["device_s"]) / int(r["shards"]))


def test_meshes_put_shards_on_cards_in_turn(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    sizes = [[d.index for d in m] for m in scaling._meshes("cuda", 5)]
    assert sizes == [[0], [0, 1], [0, 1, 0, 1], [0, 1, 0, 1, 0]]
    assert [len(m) for m in scaling._meshes("cuda", None)] == [1, 2]
    assert [set(m) for m in scaling._meshes("cpu", None)] == [
        {torch.device("cpu")}] * 2


def test_no_card_no_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device_time"], ["--distributed", "2"]):
        with pytest.raises(RuntimeError, match="is_available"):
            scaling.main(argv + ["--out", str(tmp_path / "x.csv")])
    assert not (tmp_path / "x.csv").exists()


def test_refuses_more_processes_than_a_card_holds(monkeypatch):
    monkeypatch.setattr(M, "make_mesh", lambda: (torch.device("cuda", 0),))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (5 * scaling.PROCESS_BYTES, 10 << 40))
    scaling._check_capacity("cuda", 5)
    with pytest.raises(ValueError, match="6 on cuda:0"):
        scaling._check_capacity("cuda", 6)


def test_a_worker_past_its_time_limit_fails_the_run():
    with pytest.raises(RuntimeError, match="outlived"):
        scaling.run_distributed(2, 128, 150, "cpu", timeout_s=0.5)
