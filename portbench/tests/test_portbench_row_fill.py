"""The one-word kernel's row counter metric, ``row_fill``: in the tiny
cell's traced line on the CPU (where the program's plain version counts
the rows the kernel would), listed for the chained cell only, and absent,
without an error, where the program has no such counters or no tile ran
the one-word kernel."""

import json
from types import SimpleNamespace

from portbench import cells
from portbench.tests.portbench_tiny import REPO
from portbench.tests.test_portbench_cell import _run, copy_root  # noqa: F401
from portbench.tests.test_portbench_spans import _reader


def test_row_fill_is_listed_for_the_chained_cell():
    chained = [m.name for m in cells.load(REPO, "w64_chained").per_layer]
    wide = [m.name for m in cells.load(REPO, "w256_truth").per_layer]
    assert "row_fill" in chained and "row_fill" not in wide


def test_row_fill_reads_work_over_slots():
    ctx = SimpleNamespace(calls=2, pairs_per_call=10,
                          stats=SimpleNamespace(row_slots=400, row_work=100))
    assert _reader("row_fill")(ctx) == 0.25


def test_row_fill_reads_nothing_without_rows():
    # W > 64: the counters stay 0; a program without them
    zero = SimpleNamespace(stats=SimpleNamespace(row_slots=0, row_work=0))
    assert _reader("row_fill")(zero) is None
    absent = SimpleNamespace(stats=SimpleNamespace(runs=5))
    assert _reader("row_fill")(absent) is None


def test_tiny_traced_line_carries_row_fill(copy_root):  # noqa: F811
    line = json.loads(_run(copy_root, 1).stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    m = line["metrics"]["row_fill"]
    assert m["unit"] == "share" and 0 < m["value"] < 1
