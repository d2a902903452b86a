"""The window lab's source variants of csrc/genasm_windows1.cu.

The variants are built and timed only on a card; here each one's text
edits are checked against the kernel source as it stands, so a change to
the kernel that moves an anchor fails here.
"""

import os

import pytest

torch = pytest.importorskip("torch")

from scrooge_tpu_torch.ops import _cuda  # noqa: E402
from scrooge_tpu_torch.tools import window_lab  # noqa: E402

SOURCE = os.path.join(_cuda.CSRC, _cuda.GENASM_WINDOWS1.source)


@pytest.mark.parametrize("variant", window_lab.VARIANTS)
def test_variant_source_applies(variant):
    with open(SOURCE) as f:
        src = f.read()
    got = window_lab.variant_source(variant)
    assert (got == src) == (variant == "full")
    # every edit adds to the source or swaps one constant; none drops a line
    assert len(got.splitlines()) >= len(src.splitlines())
    if variant == "clocks":
        assert got.count("clock64()") == 4
        assert "cy[2 * nb + b] = cyc[2];" in got


def test_variant_anchor_must_match_once(monkeypatch):
    monkeypatch.setitem(window_lab._EDITS, "ch4",
                        (("constexpr int CH = 7;", "constexpr int CH = 4;"),))
    with pytest.raises(ValueError, match="occurs 0 times"):
        window_lab.variant_source("ch4")
    with pytest.raises(ValueError, match="is not one of"):
        window_lab.variant_source("nostore")


def test_lab_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        window_lab.main(["full", "--reads", "128"])
