"""The port's public API on the CPU against the scalar oracle and the
reference's frozen outputs.

align_pairs / align_reads with device="cpu" run the plain torch engine,
the torch compaction and token coding, and the native decoders. Results
are held bit-exactly against the parity corpus (the original C++'s
outputs), the reference's golden cases and pyref.
"""

import dataclasses
import gzip
import os
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scrooge_tpu  # noqa: E402
import scrooge_tpu_torch as st  # noqa: E402
from scrooge_tpu import pyref  # noqa: E402
from scrooge_tpu.api import _prepare_genome_host  # noqa: E402
from scrooge_tpu.cli.tests_cli import (GOLDEN_DISTANCES,  # noqa: E402
                                       GOLDEN_READS, GOLDEN_REFERENCE)
from scrooge_tpu.config import AlignConfig as JaxAlignConfig  # noqa: E402
from scrooge_tpu.datamodel import Genome as JaxGenome  # noqa: E402
from scrooge_tpu.utils import simulate as jax_simulate  # noqa: E402
from scrooge_tpu_torch import (AlignConfig, AlignmentError,  # noqa: E402
                               CandidateLocation, Genome, Read)
from scrooge_tpu_torch.utils import simulate as port_simulate  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

CORPUS = os.path.join(os.path.dirname(__file__), "data",
                      "parity_corpus.tsv.gz")
CPU = "cpu"


def _random_cases(seed, count, max_len=200):
    rng = random.Random(seed)
    cases = []
    while len(cases) < count:
        t = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, max_len)))
        q = []
        for c in t:
            r = rng.random()
            if r < 0.03:
                continue
            if r < 0.06:
                q.append(rng.choice("ACGT"))
            q.append(c if r >= 0.045 or r < 0.03 else rng.choice("ACGT"))
        cases.append((t, "".join(q)))
    return cases


@pytest.mark.parametrize("wko", [(16, 16, 9), (32, 32, 17), (64, 48, 33),
                                 (64, 64, 2), (64, 64, 33), (64, 64, 48),
                                 (96, 96, 49), (128, 128, 65),
                                 (192, 192, 97), (256, 256, 129)])
def test_corpus_parity(wko):
    """Every corpus config, queries up to 600 bp. (64, 64, 2) has
    tb_limit 62 and takes the uint16 run path instead of the tokens, as
    do the wide configs (tb_limit 47 to 127, bitvectors of 2 to 4
    words)."""
    cases = []
    with gzip.open(CORPUS, "rt") as f:
        for line in f:
            W, K, O, text, query, ed, cigar = line.rstrip("\n").split("\t")
            if (int(W), int(K), int(O)) == wko and len(query) <= 600:
                cases.append((text, query, int(ed), cigar))
    assert len(cases) > 50
    W, K, O = wko
    got = st.align_pairs([c[0] for c in cases], [c[1] for c in cases],
                         AlignConfig(W=W, K=K, O=O), device=CPU)
    for (text, query, ed, cigar), a in zip(cases, got):
        assert (a.edit_distance, a.cigar) == (ed, cigar)


def test_golden_cases_four_way():
    """The reference's kernel unit tests (nine reads against a 16 bp
    reference), through both interfaces of the port and of pyref."""
    reads = [q for _, q in GOLDEN_READS]
    refs = [GOLDEN_REFERENCE] * len(reads)
    genome = Genome(content=GOLDEN_REFERENCE)
    mapped = [Read(description=d, content=q,
                   locations=[CandidateLocation(start_in_reference=0)])
              for d, q in GOLDEN_READS]
    pyref_cfg = AlignConfig(backend="pyref")
    jax_cfg = JaxAlignConfig(backend="pyref")
    jax_genome = JaxGenome(content=GOLDEN_REFERENCE)
    results = [
        st.align_pairs(refs, reads, device=CPU),
        st.align_reads(genome, mapped, device=CPU),
        scrooge_tpu.align_all(refs, reads, config=jax_cfg),
        scrooge_tpu.align_all(jax_genome, mapped, config=jax_cfg),
        st.align_all(refs, reads, config=pyref_cfg),
        st.align_all(genome, mapped, config=pyref_cfg),
    ]
    for res in results:
        assert [a.edit_distance for a in res] == GOLDEN_DISTANCES
        assert [a.cigar for a in res] == [a.cigar for a in results[2]]


def test_random_pairs_and_reads_match_pyref():
    cfg = AlignConfig()
    cases = _random_cases(23, 40)
    cases += [("ACGT" * 40, ""), ("ACGT", "ACGTACGT" * 6)]
    got = st.align_all([t for t, _ in cases], [q for _, q in cases],
                       config=cfg, device=CPU)
    for (t, q), a in zip(cases, got):
        assert (a.edit_distance, a.cigar) == pyref.align_pair(t, q, cfg)

    rng = random.Random(4)
    gstr = "".join(rng.choice("ACGT") for _ in range(3000))
    reads, want = [], []
    for i in range(24):
        start = rng.randint(0, 2900)
        q = gstr[start : start + rng.randint(20, 300)]
        q = q[:10] + "T" + q[12:]
        locs = [CandidateLocation(start_in_reference=start),
                CandidateLocation(start_in_reference=max(start - 3, 0))]
        reads.append(Read(description=f"r{i}", content=q, locations=locs))
        for loc in locs:
            s = loc.start_in_reference
            bound = cfg.max_windows(len(q)) * cfg.tb_limit + cfg.W
            want.append(pyref.align_pair(gstr[s : s + bound], q, cfg))
    got = st.align_all(Genome(content=gstr), reads, config=cfg, device=CPU)
    assert [(a.edit_distance, a.cigar) for a in got] == want


@pytest.mark.parametrize("wko", [(64, 64, 33), (64, 64, 2), (128, 128, 65)])
def test_return_packed_matches_strings(wko):
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O, batch_tile=128)
    cases = _random_cases(31, 300, max_len=70)  # three tiles
    texts = [t for t, _ in cases]
    queries = [q for _, q in cases]
    strs, stats = st.align_pairs(texts, queries, cfg, return_stats=True,
                                 device=CPU)
    packed = st.align_pairs(texts, queries, cfg, return_packed=True,
                            device=CPU)
    assert stats.num_pairs == len(cases) and stats.core_ns > 0
    assert packed.to_alignments() == strs
    genome = Genome(content="".join(texts))
    starts = np.cumsum([0] + [len(t) for t in texts[:-1]])
    reads = [Read(description="r", content=q,
                  locations=[CandidateLocation(start_in_reference=int(s))])
             for q, s in zip(queries, starts)]
    s2 = st.align_reads(genome, reads, cfg, device=CPU)
    p2 = st.align_reads(genome, reads, cfg, return_packed=True, device=CPU)
    assert p2.to_alignments() == s2


def test_unalignable_pair_raises():
    cfg = AlignConfig(W=32, K=4, O=17)
    with pytest.raises(AlignmentError):
        st.align_pairs(["A" * 40], ["C" * 40], cfg, device=CPU)
    a, stats = st.align_pairs(["A" * 40], ["A" * 39], cfg, return_stats=True,
                              device=CPU)
    assert (a[0].edit_distance, a[0].cigar) == pyref.align_pair(
        "A" * 40, "A" * 39, cfg)
    assert stats.retried_pairs == 0


@pytest.mark.parametrize("packed", [False, True])
def test_failed_lanes_are_retried_on_pyref(monkeypatch, packed):
    """Lanes the engine fails go to the scalar oracle and come back
    exact, in pair order, counted in the stats."""
    from scrooge_tpu_torch.ops import engine

    real = engine.align_batch

    def failing(*args, **kwargs):
        res = real(*args, **kwargs)
        res.failed[::3] |= engine.FAIL_INCOMPLETE
        return res

    monkeypatch.setattr(engine, "align_batch", failing)
    cfg = AlignConfig()
    cases = _random_cases(41, 10, max_len=120)
    out, stats = st.align_pairs([t for t, _ in cases], [q for _, q in cases],
                                cfg, return_stats=True,
                                return_packed=packed, device=CPU)
    got = out.to_alignments() if packed else out
    assert [(a.edit_distance, a.cigar) for a in got] == [
        pyref.align_pair(t, q, cfg) for t, q in cases]
    assert stats.retried_pairs == stats.fail_incomplete_pairs == 4


def test_unsupported_configs_and_backends():
    with pytest.raises(NotImplementedError, match="12-bit run count"):
        st.align_pairs(["ACGT"], ["ACGT"],
                       AlignConfig(W=2049, K=2049, O=1025), device=CPU)
    for backend in ("pallas", "xla"):
        with pytest.raises(ValueError):
            st.align_pairs(["ACGT"], ["ACGT"], AlignConfig(backend=backend),
                           device=CPU)
    got = st.align_pairs(["ACGTACGT"], ["ACTTACGT"],
                         AlignConfig(backend="pyref"), device=CPU)
    assert got[0].edit_distance == 1


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        st.align_pairs(["ACGT"], ["ACGT"], device="cuda")
    genome = Genome(content="ACGT" * 10)
    with pytest.raises(RuntimeError, match="cuda"):
        st.align_reads(genome, [], device="cuda")


def test_prepared_genome_words_match_jax_package():
    """The packed genome is the state the two packages share: the same
    string gives the same words, passed between them as numpy."""
    rng = random.Random(6)
    content = "".join(rng.choice("ACGT") for _ in range(5003))
    want = _prepare_genome_host(JaxGenome(content=content), "pallas")[0]
    genome = Genome(content=content)
    prepared = st.prepare_genome(genome)
    words = prepared.device_words(CPU)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    read = Read(description="r", content=content[100:300],
                locations=[CandidateLocation(start_in_reference=100)])
    for src in (genome, prepared):
        a = st.align_all(src, [read], device=CPU)[0]
        assert (a.edit_distance, a.cigar) == (0, "31=" * 6 + "14=")
    with pytest.raises(TypeError):
        st.align_reads(scrooge_tpu.api.prepare_genome(JaxGenome(content)),
                       [read], device=CPU)


def test_align_config_maps_across_packages():
    for kw in ({}, dict(W=128, K=100, O=65, batch_tile=256,
                        early_termination=False, backend="pyref",
                        tb_cap_override=7, margin_override=3)):
        jax_cfg = JaxAlignConfig(**kw)
        cfg = AlignConfig(**dataclasses.asdict(jax_cfg))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
        assert JaxAlignConfig(**dataclasses.asdict(cfg)) == jax_cfg
        assert (cfg.tb_limit, cfg.columns, cfg.rows) == (
            jax_cfg.tb_limit, jax_cfg.columns, jax_cfg.rows)
        assert [cfg.max_windows(n) for n in (0, 1, 999, 10_000)] == [
            jax_cfg.max_windows(n) for n in (0, 1, 999, 10_000)]
    for bad in (dict(W=1), dict(O=64), dict(K=0), dict(batch_tile=100),
                dict(tb_cap_override=65), dict(margin_override=65)):
        for cls in (AlignConfig, JaxAlignConfig):
            with pytest.raises(ValueError):
                cls(**bad)


def test_simulate_dataset_matches_jax_package():
    kw = dict(genome_len=20_000, num_reads=40, read_len=900, accuracy=0.9,
              seed=7)
    want = jax_simulate.simulate_dataset(**kw)
    got = port_simulate.simulate_dataset(**kw)
    assert dataclasses.asdict(got.genome) == dataclasses.asdict(want.genome)
    assert [dataclasses.asdict(r) for r in got.reads] == [
        dataclasses.asdict(r) for r in want.reads]


def test_pyref_backend_matches_jax_pyref_backend():
    """The port's own scalar-oracle backend against the JAX package's,
    both interfaces, strings and packed, including its errors."""
    cases = _random_cases(12, 12, max_len=150)
    texts, queries = [t for t, _ in cases], [q for _, q in cases]
    cfg = AlignConfig(W=32, K=32, O=17, backend="pyref")
    jcfg = JaxAlignConfig(W=32, K=32, O=17, backend="pyref")
    got = st.align_pairs(texts, queries, cfg)
    assert got == [st.Alignment(a.cigar, a.edit_distance)
                   for a in scrooge_tpu.align_all(texts, queries, config=jcfg)]
    packed = st.align_pairs(texts, queries, cfg, return_packed=True)
    assert packed.to_alignments() == got
    genome = Genome(content="".join(texts))
    starts = np.cumsum([0] + [len(t) for t in texts[:-1]])
    reads = [Read(description="r", content=q,
                  locations=[CandidateLocation(start_in_reference=int(s))])
             for q, s in zip(queries, starts)]
    want = scrooge_tpu.align_all(JaxGenome(content=genome.content), reads,
                                 config=jcfg)
    assert [(a.edit_distance, a.cigar) for a in st.align_all(
        genome, reads, config=cfg)] == [(a.edit_distance, a.cigar)
                                        for a in want]
    with pytest.raises(AlignmentError):
        st.align_pairs(["C" * 32], ["A" * 32], AlignConfig(W=32, K=8, O=17,
                                                           backend="pyref"))
    bad = [Read(description="r", content="ACGT",
                locations=[CandidateLocation(start_in_reference=-1)])]
    with pytest.raises(ValueError, match="out of genome bounds"):
        st.align_reads(genome, bad, cfg)
