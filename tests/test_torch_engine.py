"""The port's plain window engine against the JAX package's engines.

Same numpy inputs from a seed through engine_xla (and once through the
Pallas kernel in interpret mode, as tests/test_engine_pallas.py runs it)
and through scrooge_tpu_torch's plain torch engine on the CPU. Every
output is an integer, so every comparison is exact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from scrooge_tpu.config import AlignConfig  # noqa: E402
from scrooge_tpu.ops import engine_pallas, engine_xla  # noqa: E402
from scrooge_tpu_torch.ops import compact, engine, pack  # noqa: E402
from scrooge_tpu_torch.utils.simulate import (  # noqa: E402
    edge_pairs, multiword_edge_batch)
from torch_threads import one_intra_op_thread  # noqa: E402,F401


def _mutate(rng, seq, rate):
    out = []
    for c in seq:
        r = rng.random()
        if r < rate / 3:
            continue  # deletion
        if r < 2 * rate / 3:
            out.append(int(rng.integers(0, 4)))  # substitution
            continue
        if r < rate:
            out.append(int(rng.integers(0, 4)))  # insertion
        out.append(int(c))
    return out


def _batch(seed, B, T, P, rate=0.08, short_plen=None):
    """Texts (B, T) and mutated patterns (B, P) as 2-bit codes, with
    ragged lengths, an empty read and a text that runs out first.

    With ``short_plen``, every other text is whole (the reads end inside
    them) and the one text that runs out does so against a read of
    ``short_plen`` chars: the d-search of that lane still crosses the
    first word boundaries without searching all of a wide K."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, (B, T), dtype=np.uint8)
    pattern = np.zeros((B, P), np.uint8)
    if short_plen is None:
        tlen = rng.integers(1, T + 1, B).astype(np.int32)
    else:
        tlen = np.full(B, T, np.int32)
    plen = np.zeros(B, np.int32)
    for b in range(B):
        q = _mutate(rng, text[b, : tlen[b]], rate)[: int(rng.integers(0, P + 1))]
        pattern[b, : len(q)] = q
        plen[b] = len(q)
    plen[0] = 0
    tlen[1], plen[1] = 5, short_plen or P  # text exhausted before the read
    return text, tlen, pattern, plen


def _port(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_same(rx, rt):
    """ed, failure mask, counts and compacted runs."""
    np.testing.assert_array_equal(rt.edit_distance.numpy(),
                                  np.asarray(rx.edit_distance))
    np.testing.assert_array_equal(rt.failed.numpy() != 0,
                                  np.asarray(rx.failed) != 0)
    np.testing.assert_array_equal(rt.counts.numpy(), np.asarray(rx.counts))
    cap = int(rt.counts.sum(0).max()) + 2
    ct, tt = compact.compact_entries(rt.entries, rt.counts, cap)
    cx, tx = engine_xla.compact_entries(rx.entries, rx.counts, cap)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tx))
    np.testing.assert_array_equal(ct.numpy().view(np.uint16), np.asarray(cx))


def test_pack_2bit_matches_jax_packing():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, (7, 53), dtype=np.uint8)
    got = pack.pack_2bit(_port(codes)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, engine_pallas.pack_2bit_host(codes))


@pytest.mark.parametrize("wko", [(32, 32, 17), (64, 64, 33), (16, 16, 9),
                                 (96, 96, 49), (128, 128, 65),
                                 (192, 192, 97), (256, 256, 129)])
def test_plain_engine_matches_xla_engine(wko):
    """W <= 64 holds a bitvector in one word; 96 and 128 in two, 192 in
    three and 256 in four. Each batch has a lane whose text runs out
    after 5 chars, so its d-search passes every word boundary."""
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O)
    if W <= 64:
        P, text, tlen, pattern, plen = 128, *_batch(11 + W, 128, 160, 128)
    else:
        P, text, tlen, pattern, plen = 260, *_batch(11 + W, 128, 300, 260,
                                                    short_plen=140)
    maxw = cfg.max_windows(P)
    rx = engine_xla.align_batch(cfg, maxw, text, tlen, pattern, plen)
    rt = engine.align_batch(cfg, maxw, pack.pack_2bit(_port(text)),
                            _port(tlen), pack.pack_2bit(_port(pattern)),
                            _port(plen))
    assert int(rt.counts.sum()) > 0
    _assert_same(rx, rt)


@pytest.mark.parametrize("wko", [(64, 64, 33), (48, 48, 25), (64, 64, 2),
                                 (64, 64, 0), (64, 16, 33)])
def test_plain_engine_matches_xla_engine_on_edge_pairs(wko):
    """The branches the one-word kernels must reproduce, pinned against
    engine_xla: unrelated pairs (window distances past 16 rows; FAIL_TB at
    K=16), 25 % errors, a text that runs out (n = 0), one-character last
    windows, an empty read; W < 64 (the top-bit mask) and O = 2 / O = 0
    (62 and 64 chars traced back, 63 and 65 stored columns). The same
    inputs go through the kernels in tests/test_torch_cuda.py."""
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O)
    B, T, P = 64, 300, 280
    text, tlen, pattern, plen = edge_pairs(W + O + K, B, T, P, cfg.tb_limit)
    maxw = cfg.max_windows(P)
    pad = ((0, 128 - B), (0, 0))  # engine_xla takes lanes in 128s
    rx = engine_xla.align_batch(cfg, maxw, np.pad(text, pad),
                                np.pad(tlen, pad[0]), np.pad(pattern, pad),
                                np.pad(plen, pad[0]))
    rx = type(rx)(*(np.asarray(x)[..., :B] for x in rx))
    rt = engine.align_batch(cfg, maxw, pack.pack_2bit(_port(text)),
                            _port(tlen), pack.pack_2bit(_port(pattern)),
                            _port(plen))
    if K == 16:
        assert int((rt.failed == engine.FAIL_TB).sum()) > 0
    else:
        assert int(rt.failed.ne(0).sum()) == 0
        assert int(rt.work[0].max()) > 17 * (W + 1)  # rows past 16
    assert int((rt.counts.sum(0) > 0).sum()) > B // 2
    _assert_same(rx, rt)


# configs the multiword kernel (genasm_windows.cu) must reproduce: O = 2
# and 0 keep every stored word (FTW = 0) and trace back 126 and 128 chars;
# O = 65 and 129 store the top words only, O = 49 and W = 96, 130 leave a
# partial top word, K = 16 fails the unrelated lanes
MULTIWORD_EDGE_CONFIGS = [(128, 128, 65), (96, 96, 49), (128, 128, 2),
                          (128, 128, 0), (130, 130, 66), (192, 192, 97),
                          (256, 256, 129), (128, 16, 65)]


@pytest.mark.parametrize("wko", MULTIWORD_EDGE_CONFIGS)
def test_plain_engine_matches_xla_engine_on_multiword_edge_pairs(wko):
    """The branches of the multiword kernel, pinned against engine_xla on
    edge_pairs batches (unrelated pairs, texts that run out, one-character
    last windows, an empty read) of reads of up to 3 windows. The same
    inputs go through the kernel in tests/test_torch_cuda.py."""
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O)
    text, tlen, pattern, plen = multiword_edge_batch(cfg)
    B, P = pattern.shape
    maxw = cfg.max_windows(P)
    pad = ((0, 128 - B), (0, 0))  # engine_xla takes lanes in 128s
    rx = engine_xla.align_batch(cfg, maxw, np.pad(text, pad),
                                np.pad(tlen, pad[0]), np.pad(pattern, pad),
                                np.pad(plen, pad[0]))
    rx = type(rx)(*(np.asarray(x)[..., :B] for x in rx))
    rt = engine.align_batch(cfg, maxw, pack.pack_2bit(_port(text)),
                            _port(tlen), pack.pack_2bit(_port(pattern)),
                            _port(plen))
    if K == 16:
        assert int((rt.failed == engine.FAIL_TB).sum()) > 0
    else:
        assert int(rt.failed.ne(0).sum()) == 0
        assert int((rt.counts.sum(0) > 0).sum()) > B // 2
    _assert_same(rx, rt)


@pytest.mark.parametrize("W", [16, 64, 65, 192, 193, 256, 257, 2048])
def test_window_kernel_follows_word_count(W):
    """The config alone picks the CUDA kernel: genasm_windows1.cu for one
    word, genasm_windows.cu for two and three, genasm_windows_wide.cu for
    four and more; CPU tensors take the plain version and launch none."""
    from scrooge_tpu_torch.ops import _cuda

    cfg = AlignConfig(W=W, K=W, O=W // 2 + 1)
    want = (_cuda.GENASM_WINDOWS1 if W <= 64 else _cuda.GENASM_WINDOWS
            if W <= 192 else _cuda.GENASM_WINDOWS_WIDE)
    assert engine.window_kernel(cfg) is want
    before = [dict(k.counts) for k in (_cuda.GENASM_WINDOWS1,
                                        _cuda.GENASM_WINDOWS,
                                        _cuda.GENASM_WINDOWS_WIDE)]
    words = torch.zeros((1, -(-W // 16)), dtype=torch.int32)
    args = (words, torch.zeros(1, dtype=torch.int64),
            torch.full((1,), W, dtype=torch.int32), words,
            torch.full((1,), W, dtype=torch.int32))
    res = engine.align_windows(cfg, cfg.max_windows(W), *args)
    assert int(res.edit_distance[0]) == 0 and int(res.failed[0]) == 0
    assert [dict(k.counts) for k in (_cuda.GENASM_WINDOWS1,
                                     _cuda.GENASM_WINDOWS,
                                     _cuda.GENASM_WINDOWS_WIDE)] == before


@pytest.mark.parametrize("W", [16, 32, 64])
def test_one_word_kernel_takes_no_scratch(W):
    """At one word a warp runs a pair, with R and the forefront in its
    shared memory: no device scratch, so a tile is one launch whatever
    the budget, and an empty tile none."""
    cfg = AlignConfig(W=W, K=W, O=W // 2 + 1)
    assert engine.pairs_per_warp(cfg) == 1
    assert engine.scratch_words(cfg, 1024) == (0, 0)
    for budget in (0, 1, 10 ** 15):
        assert engine.launch_chunks(cfg, 1024, budget) == [(0, 1024)]
    assert engine.launch_chunks(cfg, 0, 0) == []


@pytest.mark.parametrize("et, K, slots, work", [
    # passes of 32 rows up to the one with the first hit; a window with
    # no hit spans every row <= K
    (True, 64, 32 + 32 + 64 + 64 + 65, 1 + 32 + 33 + 41 + 65),
    (False, 64, 5 * 65, 1 + 32 + 33 + 41 + 65),
    # K = 40 inside the second pass: it spans rows 32..40
    (True, 40, 32 + 32 + 41 + 41 + 41, 1 + 32 + 33 + 41 + 41),
])
def test_row_counts_by_hand(et, K, slots, work):
    """BatchResult.rows of five windows: first hits in rows 0, 31, 32 and
    40, and one window with no hit."""
    cfg = AlignConfig(W=64, K=K, O=33, early_termination=et)
    wed = torch.tensor([0, 31, 32, 40, 0])
    hit = torch.tensor([True, True, True, True, False])
    assert engine.row_counts(cfg, wed, hit).tolist() == [slots, work]


@pytest.mark.parametrize("source, name, want", [
    ("genasm_windows1.cu", "ROWS", 32),
    ("genasm_windows1.cu", "UNROLL", 16),
    ("genasm_windows_wide.cu", "FF_PAD", engine.WIDE_FF_PAD),
])
def test_source_constant(source, name, want):
    """A kernel's compile-time constants as the host reads them; the
    one-word kernel's pass is the plain version's (engine.row_counts)."""
    from scrooge_tpu_torch.ops import _cuda

    assert _cuda.source_constant(source, name) == want
    assert engine.WINDOWS1_ROWS == 32
    with pytest.raises(ValueError, match="0 definitions of ROWS"):
        _cuda.source_constant("genasm_windows_wide.cu", "ROWS")


@pytest.mark.parametrize("wko", [(64, 64, 33), (128, 128, 65),
                                 (256, 256, 129)])
def test_plain_engine_mapped_matches_xla_engine(wko):
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O)
    rng = np.random.default_rng(21 + W)
    G, B, P = 4000, 128, 200
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    starts = rng.integers(0, G - P, B).astype(np.int64)
    starts[:4] = [0, G - 40, G - 1, G]  # genome ends inside the window
    pattern = np.zeros((B, P), np.uint8)
    plen = rng.integers(1, P + 1, B).astype(np.int32)
    for b in range(B):
        q = _mutate(rng, genome[starts[b] : starts[b] + plen[b]], 0.06)
        q = q[: plen[b]]
        pattern[b, : len(q)] = q
        plen[b] = len(q)
    maxw = -(-cfg.max_windows(P) // 32) * 32
    tlen = np.minimum(G - starts, maxw * cfg.tb_limit + cfg.W).astype(
        np.int32)
    rx = engine_xla.align_batch_mapped(cfg, maxw, genome,
                                       starts.astype(np.uint32), tlen,
                                       pattern, plen)
    rt = engine.align_windows(cfg, maxw, pack.pack_2bit(_port(genome)),
                              _port(starts), _port(tlen),
                              pack.pack_2bit(_port(pattern)), _port(plen))
    _assert_same(rx, rt)


def test_plain_engine_matches_pallas_interpret():
    """The Pallas kernel (interpret mode off the TPU), compared on lanes
    that neither engine fails."""
    cfg = AlignConfig(W=32, K=32, O=17)
    B, T, P = 128, 64, 48
    rng = np.random.default_rng(5)
    text = rng.integers(0, 4, (B, T), dtype=np.uint8)
    pattern = np.where(rng.random((B, P)) < 0.1,
                       rng.integers(0, 4, (B, P), dtype=np.uint8),
                       text[:, :P]).astype(np.uint8)
    tlen = rng.integers(1, T + 1, B).astype(np.int32)
    plen = rng.integers(0, P + 1, B).astype(np.int32)
    maxw = cfg.max_windows(P)
    tw, pw = (engine_pallas.pack_2bit_host(text),
              engine_pallas.pack_2bit_host(pattern))
    rp = engine_pallas.align_batch(cfg, maxw, 1, 2, tw, tlen, pw, plen)
    rt = engine.align_batch(cfg, maxw, pack.to_device(tw, "cpu"),
                            _port(tlen), pack.to_device(pw, "cpu"),
                            _port(plen))
    ok = (np.asarray(rp.failed) == 0) & (rt.failed.numpy() == 0)
    assert ok.sum() > B // 2
    np.testing.assert_array_equal(rt.edit_distance.numpy()[ok],
                                  np.asarray(rp.edit_distance)[ok])
    np.testing.assert_array_equal(rt.counts.numpy()[:, ok],
                                  np.asarray(rp.counts)[:maxw, ok])
    cap = int(rt.counts.sum(0).max()) + 2
    cp, tp = engine_pallas.compact_entries_sparse(rp.entries, rp.counts, cap)
    ct, tt = compact.compact_entries(rt.entries, rt.counts, cap)
    np.testing.assert_array_equal(tt.numpy()[ok], np.asarray(tp)[ok])
    np.testing.assert_array_equal(ct.numpy().view(np.uint16)[:, ok],
                                  np.asarray(cp)[:, ok])


def test_unalignable_window_fails_lane():
    """A window with no alignment within K sets FAIL_TB, like engine_xla's
    failure mask, and emits nothing for that lane."""
    cfg = AlignConfig(W=32, K=4, O=17)
    B = 4
    text = np.zeros((B, 40), np.uint8)
    pattern = np.ones((B, 40), np.uint8)
    pattern[0] = 0  # lane 0 aligns exactly
    tlen = np.full(B, 40, np.int32)
    plen = np.full(B, 40, np.int32)
    rx = engine_xla.align_batch(cfg, 8, np.pad(text, ((0, 124), (0, 0))),
                                np.pad(tlen, (0, 124)),
                                np.pad(pattern, ((0, 124), (0, 0))),
                                np.pad(plen, (0, 124)))
    rt = engine.align_batch(cfg, 8, pack.pack_2bit(_port(text)), _port(tlen),
                            pack.pack_2bit(_port(pattern)), _port(plen))
    assert rt.failed.tolist() == [0, engine.FAIL_TB, engine.FAIL_TB,
                                  engine.FAIL_TB]
    assert (np.asarray(rx.failed)[:B] != 0).tolist() == [False, True, True,
                                                          True]
    assert int(rt.counts[:, 1:].sum()) == 0
