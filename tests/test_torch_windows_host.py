"""The window kernels of one to three words on the host, under
sanitizers.

``tests/windows_host.cpp`` includes ``csrc/genasm_windows1.cu`` (one
word, the main path's kernel, a warp a pair) and ``csrc/genasm_windows.cu``
(two and three words, a thread a pair) themselves, not copies: the
one-word kernel's 32 threads run in lockstep over arrays, the multiword
kernel's threads one after the other. It is built with g++ under
AddressSanitizer and UBSan into ``scrooge_tpu_torch/_build/`` and run
with early termination on and off; ed, failed, every count, the runs and,
at one word, the row counters (row slots and row work) must equal the
plain engine's (``engine.align_windows_plain``) with the same setting.
The batches are ``utils.simulate.edge_pairs`` (unrelated pairs, a text
that runs out, one-character last windows, an empty read), with FAIL_TB
lanes at K = 16; ragged batches whose pairs have an exact number of
substitutions in their first window: a hit at K and at K-1, and one past
K; at one word, reads whose text runs out n chars in, so that their first
window hits in row m - n: the first and last row of a pass of 32 and of
the next (rows 0, 31, 32, 33, 34), at K or past it; and ragged batches of
decoys, pairs whose text is unrelated to their read, beside true
pairs. Four words and more
run on the wide kernel, whose host harness is
``tests/test_torch_wide_host.py``. Skips where g++ or the sanitizer
runtime is absent.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scrooge_tpu_torch.config import AlignConfig  # noqa: E402
from scrooge_tpu_torch.ops import engine, pack  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401
from torch_window_harness import (ET, assert_same,  # noqa: E402
                                  assert_subs_batch, build_harness,
                                  edge_batch, ragged_batch, run_harness)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_harness(tmp_path_factory, "windows_host")


@pytest.mark.parametrize("et", ET)
@pytest.mark.parametrize("wko", [
    (64, 64, 33),    # the main path's config
    (64, 16, 33),    # FAIL_TB lanes
    (48, 48, 25),    # W < 64: the top-bit mask
    (64, 64, 0),     # COLS = W+1: column 64 stored
    (64, 20, 33),    # K < 32: the one pass ends inside the warp
    (32, 48, 17),    # K > W: rows above W computed, not stored
    (24, 24, 13),    # a narrow window: 12 rows past K = W unused
    (128, 128, 65),  # two words, the top one stored
    (192, 64, 2),    # three words, all stored; FAIL_TB lanes
], ids=lambda w: "-".join(map(str, w)))
def test_edge_pairs_match_plain(harness, wko, et):
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O, early_termination=et)
    args = edge_batch(cfg, 70)
    maxw = cfg.max_windows(int(args[4].max()))
    got = run_harness(harness, cfg, maxw, *args)
    want = engine.align_windows_plain(cfg, maxw, *args)
    assert int((want.failed == 0).sum()) > 35
    if K == 16:
        assert int((want.failed & engine.FAIL_TB != 0).sum()) > 0
    assert_same(got, want)


@pytest.mark.parametrize("et", ET)
@pytest.mark.parametrize("wko, subs", [
    # K = 6 even: 6 hits in row K (the row pair at d = 6 also computes
    # row 7), 5 in row K-1, 7 fails; 0 and 2 hit in the first row pairs
    ((64, 6, 33), (6, 5, 7, 0, 2)),
    ((128, 6, 65), (6, 5, 7, 0, 2)),
    # K = 7 odd: the last row pair is rows 6 and 7
    ((64, 7, 33), (7, 6, 8)),
], ids=lambda v: "-".join(map(str, v)))
def test_hits_at_k_match_plain(harness, wko, subs, et):
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O, early_termination=et)
    B = 3 + len(subs) + 1 + 2
    args = ragged_batch(W + K, B, 3 * W, 2 * W, unrelated=2, rate=0.0,
                        subs=subs, tb=cfg.tb_limit)
    maxw = cfg.max_windows(int(args[4].max()))
    got = run_harness(harness, cfg, maxw, *args)
    want = engine.align_windows_plain(cfg, maxw, *args)
    assert_subs_batch(want, cfg, subs)
    assert_same(got, want)


@pytest.mark.parametrize("et", ET)
@pytest.mark.parametrize("wko", [
    (64, 64, 33),  # the main path's config under chained candidates
    (32, 32, 17),  # short reads' window
    (64, 64, 0),   # COLS = W+1
], ids=lambda w: "-".join(map(str, w)))
def test_decoys_match_plain(harness, wko, et):
    """True pairs (6 % edits) beside decoys, whose text is unrelated to
    their read, as minimap2's chained candidates give them: a decoy's
    windows hit dozens of rows down, in the second pass of 32 rows."""
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O, early_termination=et)
    args = ragged_batch(W + 7, 37, 4 * W, 3 * W, unrelated=18, rate=0.06)
    maxw = cfg.max_windows(int(args[4].max()))
    got = run_harness(harness, cfg, maxw, *args)
    want = engine.align_windows_plain(cfg, maxw, *args)
    assert int((want.failed == 0).sum()) >= 30
    # row work: a decoy's first hit lies far below a true pair's
    slots, work = (int(x) for x in want.rows)
    assert 0 < work <= slots
    assert_same(got, want)


# text lengths n of the pass-edge reads (64 chars): first hits in rows
# 64 - n, the first and last rows of the first two passes of 32, and one
# read of 100 chars whose text is its first 100
PASS_EDGE_TEXTS = (64, 33, 32, 31, 30)


def pass_edge_batch(seed):
    """Reads of 64 random chars whose text is their first n chars (n in
    PASS_EDGE_TEXTS), so that the first window's first hit is row 64 - n
    and the read's edit distance 64 - n, then a read of 100 chars equal
    to its text."""
    rng = np.random.default_rng(seed)
    B = len(PASS_EDGE_TEXTS) + 1
    pattern = rng.integers(0, 4, (B, 100), dtype=np.uint8)
    plen = np.array([64] * (B - 1) + [100], np.int32)
    tlen = np.array(PASS_EDGE_TEXTS + (100,), np.int32)
    text = pattern.copy()
    tw = pack.pack_2bit(torch.from_numpy(text))
    base = torch.arange(B, dtype=torch.int64) * (tw.shape[1] * 16)
    return (tw, base, torch.from_numpy(tlen),
            pack.pack_2bit(torch.from_numpy(pattern)),
            torch.from_numpy(plen))


@pytest.mark.parametrize("et", ET)
@pytest.mark.parametrize("wko", [
    (64, 64, 2),   # every hit in K; two passes for rows 32..34
    (64, 64, 33),  # the main path's config
    (64, 32, 33),  # K = 32: row 32 is the second pass's only row
    (64, 20, 33),  # K = 20 inside the first pass: rows 31.. fail
], ids=lambda w: "-".join(map(str, w)))
def test_pass_edges_match_plain(harness, wko, et):
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O, early_termination=et)
    args = pass_edge_batch(K + O)
    maxw = cfg.max_windows(100)
    got = run_harness(harness, cfg, maxw, *args)
    want = engine.align_windows_plain(cfg, maxw, *args)
    for b, n in enumerate(PASS_EDGE_TEXTS):
        if 64 - n <= K:
            assert int(want.failed[b]) == 0
            assert int(want.edit_distance[b]) == 64 - n
        else:
            assert int(want.failed[b]) & engine.FAIL_TB
    assert int(want.failed[-1]) == 0 and int(want.edit_distance[-1]) == 0
    assert_same(got, want)
