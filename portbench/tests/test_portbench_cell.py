"""A tiny cell run end to end on the CPU, from a copy with files added.

The copy adds a configuration, a traffic mix and a per-layer metric as
files (portbench_tiny.py); the harness finds them by name and runs the
cell through the program's plain version, and its last line parses.
"""

import json
import os
import subprocess
import sys

import pytest

from portbench.tests.portbench_tiny import CELL, REPO, tiny_copy

E2E = {"aligns_per_s", "device_peak_gib", "setup_s"}


def _run(root, trace):
    code = ("import sys\nfrom portbench import run\n"
            f"sys.exit(run.main(['--workload', '{CELL}', '--seed', "
            f"'3000000019', '--seconds', '1.5', '--trace', '{trace}'], "
            "device='cpu'))")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_prints_a_line_that_parses(copy_root, trace):
    proc = _run(copy_root, trace)
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert line["checks"] == {"wrong_answers": {"value": 0, "limit": 0}}
    tail = proc.stderr.strip().splitlines()[-1]
    assert tail.startswith("check wrong_answers 0 limit 0")
    if trace:
        # the added metric is found by its file; with no device in the
        # trace the device metrics find nothing to read and are left out
        assert line["metrics"]["traced_calls"]["value"] == 1
        assert "prep_ms_per_call" in line["metrics"]
        assert "device_idle_share" not in line["metrics"]
        assert "breakdown" in line
    else:
        assert set(line["metrics"]) == E2E


def test_no_card_no_result(copy_root):
    """Without a card the command prints no result and exits non-zero."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELL,
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=copy_root,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
