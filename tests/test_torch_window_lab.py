"""The window lab's source variants of csrc/genasm_windows1.cu,
csrc/genasm_windows.cu, csrc/genasm_windows_wide.cu and
csrc/genasm_fill_lab.cu.

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
    assert "constexpr int ROWS = 32;" in got
    unroll = 8 if variant == "u8" else 16
    assert f"constexpr int UNROLL = {unroll};" in got
    if variant == "clocks":
        # three section reads and the window's start; the sums after the
        # row counters
        assert got.count("clock64()") == 4
        assert "P.rows[2 + 2 * nb + b] = (int64_t)cyc[2];" in got


def test_thread_pair_r_words():
    """The R scratch of the one-thread-a-pair version of the one-word
    kernel, which ``--kernel_file`` and ``--against`` launch with the
    parent's file: rows 0..K+1 of 32 columns, lanes in blocks of 32."""
    from scrooge_tpu_torch.config import AlignConfig

    cfg = AlignConfig(W=64, K=64, O=33)
    assert window_lab.thread_pair_r_words(cfg, 1024) == 66 * 32 * 1024
    assert window_lab.thread_pair_r_words(cfg, 33) == 66 * 32 * 64


@pytest.mark.parametrize(
    "variant", tuple(window_lab.SOURCES["genasm_windows.cu"][2]))
def test_multiword_variant_source_applies(variant):
    path = os.path.join(_cuda.CSRC, _cuda.GENASM_WINDOWS.source)
    with open(path) as f:
        src = f.read()
    got = window_lab.variant_source(variant, "genasm_windows.cu")
    assert (got == src) == (variant == "full")
    assert len(got.splitlines()) >= len(src.splitlines())
    if variant == "clocks":
        assert got.count("clock64()") == 4
        assert "cy[2 * nb + b] = cyc[2];" in got
    if variant == "ffsmem":
        # a block's forefront rows in dynamic shared memory, opted in above
        # 48 KB, one 32-lane block a launch block
        assert "extern __shared__ uint64_t ff_smem[];" in got
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in got
        assert "<<<grid, THREADS, smem, stream>>>" in got
        assert "constexpr int THREADS = 32;" in got
        assert "constexpr int LB = 32;" in got
        assert "ff + (size_t)(b / LB)" not in got
    if variant == "tb8":
        assert "  return 8;" in got and "NW == 2 ? 4 : 8" not in got


@pytest.mark.parametrize(
    "variant", tuple(window_lab.SOURCES["genasm_fill_lab.cu"][2]))
def test_fill_lab_variant_source_applies(variant):
    path = os.path.join(_cuda.CSRC, _cuda.GENASM_FILL_LAB.source)
    with open(path) as f:
        src = f.read()
    got = window_lab.variant_source(variant, "genasm_fill_lab.cu")
    assert (got == src) == (variant == "full")
    assert len(got.splitlines()) == len(src.splitlines())
    group = {"g4": 4, "g16": 16}.get(variant, 8)
    assert f"constexpr int G = {group};" in got
    assert "constexpr int THREADS = 64;" in got


@pytest.mark.parametrize("variant", tuple(window_lab.SOURCES[window_lab.WIDE][2]))
def test_wide_variant_source_applies(variant):
    path = os.path.join(_cuda.CSRC, _cuda.GENASM_WINDOWS_WIDE.source)
    with open(path) as f:
        src = f.read()
    got = window_lab.variant_source(variant, window_lab.WIDE)
    assert (got == src) == (variant == "full")
    if variant != "nocs":  # nocs swaps the stream store for a plain one
        assert len(got.splitlines()) >= len(src.splitlines())
    knobs = {"u8": "constexpr int UNROLL = 8;",
             "u32": "constexpr int UNROLL = 32;",
             "rows1": "constexpr int MAX_ROWS = 1;",
             "rows2": "constexpr int MAX_ROWS = 2;",
             "t64": "constexpr int THREADS = 64;",
             "g8": "nw <= 4 ? (et ? &launch<8, true> : &launch<8, false>)"}
    if variant in knobs:
        assert knobs[variant] in got
    if variant == "nocs":
        assert "__stcs(" not in got and "  *p = v;" in got
    if variant == "clocks":
        # three section reads, the window's start, a step count a pass,
        # and the sums past every version's forefronts
        assert got.count("clock64()") == 4
        assert "cyc[3] += (unsigned long long)nblocks * UNROLL;" in got
        assert "P.ff + nb * (W + 4 * MAX_NW) * NW" in got


def test_wide_clocks_apply_to_the_first_version(tmp_path):
    """--kernel_file: the clock edits take the first version's column loop
    (one row a pass, a step a column) where this one has blocks of
    steps."""
    path = os.path.join(_cuda.CSRC, _cuda.GENASM_WINDOWS_WIDE.source)
    with open(path) as f:
        src = f.read()
    old = src.replace("      for (int blk = 0; blk < nblocks; ++blk) {\n",
                      "      for (int i = W - 1; i >= 0; --i) {\n")
    assert old != src
    (tmp_path / "k.cu").write_text(old)
    got = window_lab.variant_source("clocks", window_lab.WIDE,
                                    str(tmp_path / "k.cu"))
    assert "cyc[3] += (unsigned long long)W;" in got
    assert "nblocks * UNROLL" not in got
    # both loops: ambiguous
    (tmp_path / "k.cu").write_text(
        old + "      for (int blk = 0; blk < nblocks; ++blk) {\n")
    with pytest.raises(ValueError, match="2 of the anchors"):
        window_lab.variant_source("clocks", window_lab.WIDE,
                                  str(tmp_path / "k.cu"))


def test_variant_anchor_must_match_once(monkeypatch):
    edits = window_lab.SOURCES[window_lab.DEFAULT_SOURCE][2]
    monkeypatch.setitem(
        edits, "u4", (("constexpr int UNROLL = 7;",
                       "constexpr int UNROLL = 4;"),))
    with pytest.raises(ValueError, match="occurs 0 times"):
        window_lab.variant_source("u4")
    with pytest.raises(ValueError, match="is not one of"):
        window_lab.variant_source("nostore")
    with pytest.raises(ValueError, match="is not one of"):
        window_lab.variant_source("u4", "genasm_windows.cu")
    with pytest.raises(ValueError, match="is not one of"):
        window_lab.variant_source("full", "genasm_no_such_kernel.cu")
    with pytest.raises(ValueError, match="is not one of"):
        window_lab.variant_source("ffsmem", "genasm_fill_lab.cu")


def test_lab_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        window_lab.main(["full", "--reads", "128"])
