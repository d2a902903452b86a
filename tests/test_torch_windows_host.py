"""The one-thread-a-pair window kernels on the host, under sanitizers.

``tests/windows_host.cpp`` includes ``csrc/genasm_windows1.cu`` (one
word, the main path's kernel) and ``csrc/genasm_windows.cu`` (two and
three words) themselves, not copies, and runs each thread's body in turn.
It is built with g++ under AddressSanitizer and UBSan into
``scrooge_tpu_torch/_build/`` and run with early termination on and off;
ed, failed, every count and the runs must equal the plain engine's
(``engine.align_windows_plain``) with the same setting. The batches are
``utils.simulate.edge_pairs`` (unrelated pairs, a text that runs out,
one-character last windows, an empty read), with FAIL_TB lanes at K = 16,
and ragged batches whose pairs have an exact number of substitutions in
their first window: a hit at K where K is even (the row pair at d = K
computes row K+1, which must not count) and at K-1, and one past K.
Four words and more run on the wide kernel, whose host harness is
``tests/test_torch_wide_host.py``. Skips where g++ or the sanitizer
runtime is absent.
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
    return build_harness(tmp_path_factory, "windows_host")


@pytest.mark.parametrize("et", ET)
@pytest.mark.parametrize("wko", [
    (64, 64, 33),    # the main path's config
    (64, 16, 33),    # FAIL_TB lanes
    (48, 48, 25),    # W < 64: the top-bit mask
    (64, 64, 0),     # COLS = W+1: column 64 stored
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
