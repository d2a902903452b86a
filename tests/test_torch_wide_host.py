"""The wide window kernel's warp code on the host, under sanitizers.

``tests/wide_host.cpp`` includes ``csrc/genasm_windows_wide.cu`` itself
(not a copy) and stands in for the card's shuffles: the 32 threads of a
warp (32/G sub-groups of G, the rows of a pass of its one pair) run in
lockstep over an array. It is built with g++ under AddressSanitizer and
UBSan into ``scrooge_tpu_torch/_build/`` and run on ragged batches at W =
193 and 256 (G = 4, eight rows a pass), 320 and 512 (G = 8, four), 640
(G = 16, two) and 1100 and 2048 (G = 32, one), and at W = 256 on
``utils.simulate.edge_pairs`` too; ed, failed, every count and the runs
must equal the plain engine's (``engine.align_windows_plain``). The batch
has an empty
read, a text that runs out first (n = 0 in its later windows), related
pairs and unrelated ones, which fail at K = 64; the edge cases add pairs
with an exact number of substitutions in their first window (a hit in
the last row of a pass, or at K inside a pass when K is not a multiple of
the rows a pass) and a read of 100 chars (s = W - m not a multiple of 64).
The cases marked ``etoff`` run the instantiation without early
termination, whose passes run on to K after the first hit. Skips where
g++ or the sanitizer runtime is absent.
"""

import pytest

torch = pytest.importorskip("torch")

from scrooge_tpu_torch.config import AlignConfig  # noqa: E402
from scrooge_tpu_torch.ops import engine  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401
from torch_window_harness import (ET, assert_same,  # noqa: E402
                                  assert_subs_batch, build_harness,
                                  edge_batch, ragged_batch, run_harness)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_harness(tmp_path_factory, "wide_host")


def _case_id(wko, B, unrelated, subs, et=True):
    """W-K-O-B-unrelated, then the substitution counts, if any, and
    ``etoff`` without early termination."""
    return "-".join(map(str, (*wko, B, unrelated))) + "".join(
        f"-s{n}" for n in subs) + ("" if et else "-etoff")


@pytest.mark.parametrize("wko, B, unrelated, subs, et", [pytest.param(
    *case, id=_case_id(*case)) for case in [
    ((320, 320, 161), 13, 0, (), True),  # G = 8: four rows a pass
    ((512, 512, 257), 11, 0, (), True),
    ((512, 64, 257), 11, 4, (), True),  # FAIL_TB lanes
    ((512, 512, 0), 7, 0, (), True),  # COLS = W+1: the start column stored
    ((640, 640, 0), 5, 0, (), True),  # G = 16, every R word stored
    ((1100, 1100, 551), 3, 0, (), True),  # G = 32, one row a pass
    # hits in the last row of a pass of four (rows 3, 7, 11), and at 0
    ((512, 512, 257), 9, 0, (3, 7, 11, 0), True),
    # K = 6 inside the pass of rows 4..7: a hit at K, FAIL_TB at K
    ((512, 6, 257), 8, 2, (6, 5), True),
    # G = 16, two rows a pass: a hit in a pass's last row (3) and at K = 5
    ((640, 5, 0), 8, 2, (3, 5), True),
    # G = 32 at W = 2048, a small K so that R stays small on the host
    ((2048, 32, 1025), 5, 0, (31,), True),
    # without early termination: hits in the last row of a pass (3, 7)
    # and at 0, whose later passes must not move wed; K = 10 inside the
    # pass of rows 8..11, 11 substitutions past it (FAIL_TB)
    ((512, 10, 257), 11, 2, (3, 7, 0, 10, 11), False),
    # G = 16: a hit in a pass's last row (3) and at K = 5; G = 32
    ((640, 5, 0), 8, 2, (3, 5), False),
    ((2048, 8, 1025), 5, 0, (2,), False),
    # G = 4 at NW = 4, eight rows a pass: hits in the last row of a pass
    # (rows 7, 15) and at 0
    ((256, 256, 129), 9, 0, (7, 15, 0), True),
    # K = 12 inside the pass of rows 8..15: a hit at K and at K-1, 13
    # substitutions past K and unrelated pairs (FAIL_TB)
    ((256, 12, 129), 10, 2, (12, 11, 13), True),
    # the same without early termination, whose passes run on to K after
    # a hit in a pass's last row (7) or at 0
    ((256, 12, 129), 11, 2, (7, 0, 12, 13), False),
    ((256, 256, 0), 7, 0, (), True),  # COLS = W+1, every R word stored
    ((193, 193, 97), 9, 0, (), True),  # a top word of one bit
]])
def test_lane_group_matches_plain(harness, wko, B, unrelated, subs, et):
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O, early_termination=et)
    # the edge batches' other related pairs are exact copies, within any K
    args = ragged_batch(W + B, B, int(1.6 * W), int(1.4 * W), unrelated,
                        rate=0.0 if subs else 0.06, subs=subs,
                        tb=cfg.tb_limit)
    maxw = cfg.max_windows(int(args[4].max()))
    got = run_harness(harness, cfg, maxw, *args)
    want = engine.align_windows_plain(cfg, maxw, *args)
    if unrelated:
        assert int((want.failed & engine.FAIL_TB != 0).sum()) > 0
    assert int((want.failed == 0).sum()) >= B - unrelated - 1 - sum(
        n > K for n in subs)
    assert_subs_batch(want, cfg, subs)
    if subs:
        assert int(args[4][3 + len(subs)]) == 100
    assert_same(got, want)


@pytest.mark.parametrize("et", ET)
@pytest.mark.parametrize("wko", [
    (256, 32, 129),  # four words: G = 4, eight rows a pass
], ids=lambda w: "-".join(map(str, w)))
def test_edge_pairs_match_plain(harness, wko, et):
    """The edge pairs of the one-thread-a-pair kernels' host test at four
    words, which the wide kernel runs: unrelated pairs failing at K = 32,
    a text that runs out, one-character last windows, an empty read."""
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O, early_termination=et)
    args = edge_batch(cfg, 70)
    maxw = cfg.max_windows(int(args[4].max()))
    got = run_harness(harness, cfg, maxw, *args)
    want = engine.align_windows_plain(cfg, maxw, *args)
    assert int((want.failed == 0).sum()) > 35
    assert_same(got, want)
