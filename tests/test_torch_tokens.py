"""The port's compaction and token coding against the JAX package's.

engine_xla produces one batch of dense run rows; the same arrays go
through scrooge_tpu/ops/tokens.py + engine_xla and through
scrooge_tpu_torch.ops.compact / tokens. Token bytes, totals and the
strings native.format_tokens makes of them must be identical.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from scrooge_tpu import native  # noqa: E402
from scrooge_tpu.config import AlignConfig  # noqa: E402
from scrooge_tpu.ops import engine_xla  # noqa: E402
from scrooge_tpu.ops import tokens as jtokens  # noqa: E402
from scrooge_tpu_torch.ops import compact, engine  # noqa: E402
from scrooge_tpu_torch.ops import tokens as ttokens  # noqa: E402


@pytest.fixture(scope="module", params=[(64, 64, 33), (32, 32, 17)])
def runs(request):
    W, K, O = request.param
    cfg = AlignConfig(W=W, K=K, O=O)
    rng = np.random.default_rng(W)
    B, T, P = 128, 300, 256
    text = rng.integers(0, 4, (B, T), dtype=np.uint8)
    pattern = np.where(rng.random((B, P)) < 0.12,
                       rng.integers(0, 4, (B, P), dtype=np.uint8),
                       text[:, 4 : P + 4]).astype(np.uint8)
    tlen = np.full(B, T, np.int32)
    plen = rng.integers(0, P + 1, B).astype(np.int32)
    rx = engine_xla.align_batch(cfg, cfg.max_windows(P), text, tlen,
                                pattern, plen)
    res = engine.BatchResult(
        *(torch.from_numpy(np.asarray(a).copy()) for a in
          (rx.edit_distance, np.asarray(rx.failed).astype(np.int32),
           np.asarray(rx.entries).view(np.int16), rx.counts)))
    return cfg, rx, res


def _np(t):
    return t.numpy()


def test_batch_meta(runs):
    _, rx, res = runs
    got = _np(compact.batch_meta(res))
    want = np.asarray(engine_xla.batch_meta(rx))
    np.testing.assert_array_equal(got, want)


def test_compact_entries_u16_and_u8(runs):
    _, rx, res = runs
    cap = int(res.counts.sum(0).max())
    for cap_ in (cap + 37, max(cap // 2, 1)):  # padded, cut
        c16, t16 = compact.compact_entries(res.entries, res.counts, cap_)
        x16, xt16 = engine_xla.compact_entries(rx.entries, rx.counts, cap_)
        np.testing.assert_array_equal(_np(c16).view(np.uint16),
                                      np.asarray(x16))
        np.testing.assert_array_equal(_np(t16), np.asarray(xt16))
        c8, t8 = compact.compact_entries_u8(res.entries, res.counts, cap_)
        x8, xt8 = engine_xla.compact_entries_u8(rx.entries, rx.counts, cap_)
        np.testing.assert_array_equal(_np(c8), np.asarray(x8))
        np.testing.assert_array_equal(_np(t8), np.asarray(xt8))


def test_tokenize_u8(runs):
    _, rx, res = runs
    cap = int(res.counts.sum(0).max())
    c8, _ = compact.compact_entries_u8(res.entries, res.counts, cap)
    np.testing.assert_array_equal(_np(ttokens.tokenize_u8(c8)),
                                  np.asarray(jtokens.tokenize_u8(_np(c8))))


@pytest.mark.parametrize("two_level", [False, True])
def test_compact_tokenize_and_tokens(runs, two_level):
    cfg, rx, res = runs
    assert ttokens.supports(cfg) == jtokens.supports(cfg)
    cap = int(res.counts.sum(0).max())
    wmax = int(res.counts.max())
    ne3c = 1 << max(2, (wmax - 1).bit_length()) if two_level else 0
    tt, rt, kt = ttokens.compact_tokenize(res.entries, res.counts, cap, ne3c)
    tj, rj, kj = jtokens.compact_tokenize(rx.entries, rx.counts, cap, False,
                                          ne3c)
    np.testing.assert_array_equal(_np(tt), np.asarray(tj))
    np.testing.assert_array_equal(_np(rt), np.asarray(rj))
    np.testing.assert_array_equal(_np(kt), np.asarray(kj))
    capT = int(kt.max())
    lt = _np(ttokens.compact_tokens(tt, capT))
    lj = np.asarray(jtokens.compact_tokens(tj, capT))
    np.testing.assert_array_equal(lt, lj)
    strs = native.format_tokens(lt, _np(kt))
    assert strs == native.format_tokens(lj, np.asarray(kj))
    # the tokens decode to the same CIGARs as the plain run stream
    c16, t16 = compact.compact_entries(res.entries, res.counts, cap)
    assert strs == native.format_cigars(_np(c16).view(np.uint16), _np(t16))


def test_compact_flat_random_masks():
    """Prefix-sum + scatter routing against the log-shift routing on
    random validity patterns, including empty and full lanes."""
    rng = np.random.default_rng(8)
    L, B = 97, 64
    flat = rng.integers(1, 30000, (L, B)).astype(np.int16)
    valid = rng.random((L, B)) < rng.random(B)[None, :]
    valid[:, 0] = False
    valid[:, 1] = True
    logshift = jax.jit(engine_xla._compact_flat_logshift, static_argnums=2)
    for cap in (L + 5, 40):
        got, gt = compact.compact_flat(torch.from_numpy(flat),
                                       torch.from_numpy(valid), cap)
        want, wt = logshift(flat, valid, cap)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        np.testing.assert_array_equal(_np(gt), np.asarray(wt))
