"""The program's span metrics: in the tiny cell's traced line on the CPU,
and absent, without an error, where the program has no such field.

Five of the six metrics read host spans of the program's AlignStats and
are in the traced line wherever the program runs; the allocator count
needs a card, so the CPU line leaves it out.
"""

import importlib.util
import json
import os
from types import SimpleNamespace

import pytest

from portbench.tests.portbench_tiny import REPO
from portbench.tests.test_portbench_cell import _run, copy_root  # noqa: F401

SPANS = ("dispatch_ms_per_call", "caller_wait_ms_per_call",
         "kernel_wait_ms_per_call", "edges_ms_per_call",
         "pair_python_ms_per_call")
COUNTER = "allocator_misses_per_call"


def _reader(name):
    path = os.path.join(REPO, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("span_metric_" + name,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_tiny_traced_line_carries_the_span_metrics(copy_root):  # noqa: F811
    proc = _run(copy_root, 1)
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    for name in SPANS:
        m = line["metrics"][name]
        assert m["unit"] == "ms" and m["value"] >= 0, name
    # a call of one tile: the caller never waits on the worker
    assert line["metrics"]["caller_wait_ms_per_call"]["value"] == 0
    assert line["metrics"]["dispatch_ms_per_call"]["value"] > 0
    assert line["metrics"]["edges_ms_per_call"]["value"] > 0
    assert COUNTER not in line["metrics"]  # no card
    assert "edges=" in proc.stderr and "allocator_misses=" in proc.stderr


@pytest.mark.parametrize("name", SPANS + (COUNTER,))
def test_a_program_without_the_field_reads_nothing(name):
    """The parent of the spans has no such field: nothing to read."""
    ctx = SimpleNamespace(calls=2, stats=SimpleNamespace(prep_ns=5),
                          trace=SimpleNamespace(busy_s=1.0))
    assert _reader(name)(ctx) is None


def test_the_counter_reads_a_card_run_only():
    stats = SimpleNamespace(allocator_misses=6)
    read = _reader(COUNTER)
    assert read(SimpleNamespace(calls=2, stats=stats,
                                trace=SimpleNamespace(busy_s=0.5))) == 3
    assert read(SimpleNamespace(calls=2, stats=stats,
                                trace=SimpleNamespace(busy_s=0.0))) is None
