"""The tiny cell on the card, and the control read there: tests that need
an NVIDIA card (marker ``cuda``), skipped without one."""

import pytest
import torch

from portbench import cells, control, run
from portbench.tests.portbench_tiny import CELL, tiny_copy


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = tiny_copy(str(tmp_path_factory.mktemp("bench")))
    return cells.load(root, CELL, here=f"{root}/portbench")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_on_the_card(cell, trace):
    _need_card()
    line = run.run_cell(cell, 2147483659, 1.0, trace, device="cuda")
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
        assert "window_kernel_ms_per_call" in line["metrics"]
        assert 0 < line["metrics"]["window_kernel_roofline_pct"]["value"] \
            <= 100


@pytest.mark.cuda
def test_control_fails_on_the_card(cell):
    _need_card()
    assert control.read_control(cell, 2147483659, "cuda")[
        "control_wrong_answers"] > 0


def test_control_fails_here(cell):
    assert control.read_control(cell, 2147483659, "cpu")[
        "control_wrong_answers"] > 0
