"""Windows wider than 256 (W = 257..2048) on the CPU, against the JAX
package's scalar oracle.

The port's plain engine (``ops/engine.align_windows_plain``, what
``device="cpu"`` runs and what the wide CUDA kernel is held to on the
card) through ``st.align_pairs`` / ``st.align_reads`` against
``scrooge_tpu.pyref`` pair by pair, bit-exactly: edit distance and CIGAR,
or the same refusal for a pair with no alignment within K. The pairs are
made from a seed; the batches hold an empty read, a read shorter than
the window and a text shorter than its read. Also: the limit W <= 2048,
and ``engine.launch_chunks``, the split of a tile into launches whose
scratch fits a budget.
"""

import random

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scrooge_tpu  # noqa: E402
import scrooge_tpu_torch as st  # noqa: E402
from scrooge_tpu import pyref  # noqa: E402
from scrooge_tpu.config import AlignConfig as JaxAlignConfig  # noqa: E402
from scrooge_tpu.datamodel import Genome as JaxGenome  # noqa: E402
from scrooge_tpu_torch import AlignConfig, AlignmentError  # noqa: E402
from scrooge_tpu_torch.ops import engine  # noqa: E402
from scrooge_tpu_torch.utils.simulate import simulate_dataset  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

CPU = "cpu"


def _mutate(rng, s, rate):
    out = []
    for c in s:
        r = rng.random()
        if r < rate / 3:
            continue  # deletion
        if r < 2 * rate / 3:
            out.append(rng.choice("ACGT"))  # substitution
            continue
        if r < rate:
            out.append(rng.choice("ACGT"))  # insertion
        out.append(c)
    return "".join(out)


def _cases(seed, W, lengths, rate=0.02):
    """(text, query) pairs: reads of the given lengths mutated from their
    texts, then an empty read, a read shorter than the window and a text
    shorter than its read."""
    rng = random.Random(seed)
    cases = []
    for n in lengths:
        t = "".join(rng.choice("ACGT") for _ in range(n + 64))
        cases.append((t, _mutate(rng, t[:n], rate)))
    t = "".join(rng.choice("ACGT") for _ in range(W))
    cases += [(t, ""), (t, _mutate(rng, t[: W // 3], rate)),
              (t[:100], _mutate(rng, t[:120], rate))]
    return cases


def _jax(t, q, cfg):
    """JAX pyref's (ed, cigar), or None where it finds no alignment."""
    jcfg = JaxAlignConfig(W=cfg.W, K=cfg.K, O=cfg.O)
    try:
        return pyref.genasm(pyref.encode(t), pyref.encode(q), jcfg)
    except ValueError:
        return None


@pytest.mark.parametrize("wko, lengths", [
    ((257, 257, 129), (700, 450, 1000)),   # one bit in the top word
    ((384, 384, 0), (900, 400)),           # every R word stored
    ((512, 512, 511), (90, 60)),           # one char traced a window
    ((1024, 1024, 513), (1500, 1100)),
    ((2048, 2048, 1025), (2400,)),
], ids=lambda x: "-".join(map(str, x)))
def test_plain_engine_matches_jax_pyref(wko, lengths):
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O)
    cases = _cases(W + O, W, lengths)
    got = st.align_pairs([t for t, _ in cases], [q for _, q in cases], cfg,
                         device=CPU)
    assert [(a.edit_distance, a.cigar) for a in got] == [
        _jax(t, q, cfg) for t, q in cases]
    assert got[len(lengths)] == st.Alignment("", 0)  # the empty read


def test_failing_lanes_match_jax_pyref():
    """W=512 K=64: unrelated pairs have no alignment within K; the plain
    engine fails them (FAIL_TB) and the api refuses each as JAX pyref
    does, while the related pairs of the same batch align."""
    cfg = AlignConfig(W=512, K=64, O=257)
    rng = random.Random(5)
    cases = _cases(9, 512, (700, 600))
    cases += [("".join(rng.choice("ACGT") for _ in range(600)),
               "".join(rng.choice("ACGT") for _ in range(500)))
              for _ in range(2)]
    want = [_jax(t, q, cfg) for t, q in cases]
    assert want.count(None) >= 2 and want[0] is not None
    for (t, q), w in zip(cases, want):
        if w is None:
            with pytest.raises(AlignmentError):
                st.align_pairs([t], [q], cfg, device=CPU)
        else:
            a = st.align_pairs([t], [q], cfg, device=CPU)[0]
            assert (a.edit_distance, a.cigar) == w
    stats = st.align_pairs([t for (t, _), w in zip(cases, want) if w],
                           [q for (_, q), w in zip(cases, want) if w], cfg,
                           return_stats=True, device=CPU)[1]
    assert stats.retried_pairs == 0


def test_align_reads_w512_matches_jax_pyref_backend():
    ds = simulate_dataset(genome_len=20_000, num_reads=6, read_len=1500,
                          accuracy=0.95, seed=5)
    cfg = AlignConfig(W=512, K=512, O=257)
    got = st.align_reads(ds.genome, ds.reads, cfg, device=CPU)
    packed = st.align_reads(ds.genome, ds.reads, cfg, return_packed=True,
                            device=CPU)
    want = scrooge_tpu.align_reads(
        JaxGenome(content=ds.genome.content), ds.reads,
        JaxAlignConfig(W=512, K=512, O=257, backend="pyref"))
    assert [(a.edit_distance, a.cigar) for a in got] == [
        (a.edit_distance, a.cigar) for a in want]
    assert packed.to_alignments() == got


def test_w2048_is_taken_and_w2049_refused():
    engine.check_config(AlignConfig(W=2048, K=2048, O=1025))
    t = "ACGTTGCA" * 300
    a = st.align_pairs([t], [t[:2100]], AlignConfig(W=2048, K=16, O=1025),
                       device=CPU)[0]
    assert (a.edit_distance, a.cigar) == (0, "1023=1023=54=")
    for call in (lambda c: st.align_pairs(["ACGT"], ["ACGT"], c, device=CPU),
                 lambda c: st.align_reads(st.Genome(content="ACGT"), [], c,
                                          device=CPU),
                 engine.check_config):
        with pytest.raises(NotImplementedError, match="12-bit run count"):
            call(AlignConfig(W=2049, K=2049, O=1025))


@pytest.mark.parametrize("wko, per_warp", [((64, 64, 33), 32),
                                           ((256, 256, 129), 8),
                                           ((320, 320, 161), 4),
                                           ((1024, 1024, 513), 2),
                                           ((2048, 2048, 1025), 1),
                                           ((192, 192, 97), 32)])
def test_launch_chunks(wko, per_warp):
    """Ranges cover the tile in order; each range's scratch fits the
    budget, and all but the last are whole warps of pairs. A warp holds
    ``per_warp`` pairs at one thread a pair (W = 65..192), or that many
    rows of a pass of its one pair in the wide kernel (W >= 193), 32/G of
    them, and in the one-word kernel (W <= 64), whose R is in shared
    memory: no scratch, one launch whatever the budget."""
    cfg = AlignConfig(W=wko[0], K=wko[1], O=wko[2])
    if engine.num_words(cfg.W) == 1:
        assert per_warp == engine.WINDOWS1_ROWS
        assert engine.pairs_per_warp(cfg) == 1
        assert engine.scratch_words(cfg, 1000) == (0, 0)
        for budget in (0, 10 ** 15):
            assert engine.launch_chunks(cfg, 1000, budget) == [(0, 1000)]
        return
    wide = engine.num_words(cfg.W) > engine.MULTIWORD_MAX_NW
    if wide:
        assert per_warp == 32 // engine.group_size(cfg.W)
    unit = 1 if wide else per_warp  # the wide kernel: a warp a pair
    assert engine.pairs_per_warp(cfg) == unit
    per_unit = 8 * sum(engine.scratch_words(cfg, unit))
    B = 1000
    assert engine.launch_chunks(cfg, B, 10 ** 15) == [(0, B)]
    for units in (1, 3, 7):
        budget = units * per_unit + per_unit // 2
        chunks = engine.launch_chunks(cfg, B, budget)
        assert chunks[0][0] == 0 and chunks[-1][1] == B
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert all(hi - lo == units * unit for lo, hi in chunks[:-1])
        assert all(8 * sum(engine.scratch_words(cfg, hi - lo)) <= budget
                   for lo, hi in chunks)
    assert engine.launch_chunks(cfg, 1, per_unit) == [(0, 1)]
    with pytest.raises(MemoryError, match="one warp"):
        engine.launch_chunks(cfg, B, per_unit - 1)


def test_wide_scratch_sizes():
    """W=512 K=512 O=257 stores words 4..7 (bits [256, 512)) of rows
    0..512 for 256 columns, laid out along the word group's skew (word q
    of column i at slot i + 7-q), so 256 + 3 slots a row: 4.2 MB a pair;
    the forefront is the 513 columns of 8 words laid out the same way,
    513 + 7 slots, the padding below them that the kernel's last ring
    loads read, and a slot for the row above row 0."""
    cfg = AlignConfig(W=512, K=512, O=257)
    rows, cols, nw, stored = 513, 256, 8, 4
    r, ff = engine.scratch_words(cfg, 3)
    assert r == rows * stored * (cols + stored - 1) * 3
    assert ff == (engine.WIDE_FF_PAD + cols * 2 + 1 + nw - 1 + 1) * nw * 3
    assert engine.group_size(193) == 4 and engine.group_size(256) == 4
    assert engine.group_size(257) == 8 and engine.group_size(512) == 8
    assert engine.group_size(513) == 16 and engine.group_size(2048) == 32


def test_four_word_scratch_sizes():
    """W=256 K=256 O=129, now on the wide kernel: words 2..3 (bits [128,
    256)) of rows 0..256 for 128 columns, 128 + 1 slots a row, and the
    forefront of 257 columns of 4 words, 257 + 3 slots, with the padding
    and the slot above: 67,638 words a pair, 554.1 MB a tile of 1,024."""
    cfg = AlignConfig(W=256, K=256, O=129)
    r, ff = engine.scratch_words(cfg, 1)
    assert (r, ff) == (257 * 2 * 129, (engine.WIDE_FF_PAD + 256 + 4 + 1) * 4)
    assert r + ff == 67_638
    assert engine.pairs_per_warp(cfg) == 1
    assert 8 * sum(engine.scratch_words(cfg, 1024)) == 554_090_496
