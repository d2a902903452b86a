"""The chained cell: it loads with decoys at W=64, and the three counter
metrics it brings read the program's run and warp counters in the tiny
traced line on the CPU, and nothing, without an error, where the program
has no such counters."""

import json
from types import SimpleNamespace

import pytest

from portbench import cells
from portbench.tests.portbench_tiny import REPO
from portbench.tests.test_portbench_cell import _run, copy_root  # noqa: F401
from portbench.tests.test_portbench_spans import _reader

COUNTERS = ("runs_per_pair", "readback_bytes_per_run", "warp_lane_fill")


def test_the_chained_cell_loads():
    cell = cells.load(REPO, "w64_chained")
    assert cell.chips == 1
    assert cell.traffic["decoys_per_read"] > 0
    assert cell.traffic["reads_per_call"] == 16384
    aligner = cell.config["aligner"]
    assert (aligner["W"], aligner["K"], aligner["O"]) == (64, 64, 33)
    assert aligner["early_termination"] and aligner["batch_tile"] == 1024
    names = [m.name for m in cell.per_layer]
    assert len(names) == 16 and set(COUNTERS) <= set(names)
    wide = [m.name for m in cells.load(REPO, "w256_truth").per_layer]
    assert "runs_per_pair" in wide and "warp_lane_fill" not in wide


def test_tiny_traced_line_carries_the_counters(copy_root):  # noqa: F811
    line = json.loads(_run(copy_root, 1).stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    m = {k: line["metrics"][k]["value"] for k in COUNTERS}
    # ~400-bp reads at 95 %: tens of runs a true pair, hundreds a decoy
    assert 20 < m["runs_per_pair"] < 1000
    assert m["readback_bytes_per_run"] > 0
    assert 0 < m["warp_lane_fill"] <= 1


@pytest.mark.parametrize("name", COUNTERS)
def test_a_program_without_the_counters_reads_nothing(name):
    ctx = SimpleNamespace(calls=2, pairs_per_call=10,
                          stats=SimpleNamespace(readback_bytes=5),
                          trace=SimpleNamespace(busy_s=1.0))
    assert _reader(name)(ctx) is None


def test_the_counters_read_per_pair_and_per_run():
    stats = SimpleNamespace(runs=400, readback_bytes=1000, lane_work=30,
                            warp_work=40)
    ctx = SimpleNamespace(calls=2, pairs_per_call=10, stats=stats)
    assert _reader("runs_per_pair")(ctx) == 20
    assert _reader("readback_bytes_per_run")(ctx) == 2.5
    assert _reader("warp_lane_fill")(ctx) == 0.75
    # the wide kernel runs a warp a pair: no warp work, nothing to read
    stats.warp_work = stats.lane_work = 0
    assert _reader("warp_lane_fill")(ctx) is None
