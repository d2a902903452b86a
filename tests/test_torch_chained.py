"""Reads with chained candidates (the true position and decoys at random
positions) through ``align_reads``, held to the benchmark's plain NumPy
reference, and the AlignStats counters that say what decoys add: the
CIGAR runs returned, how much of the one-word kernel's passes of rows the
windows needed (row work and row slots, summed over tiles and shards),
and how full the one-thread-a-pair kernel's warps are. The card's case
(marker ``cuda``) skips without one."""

import dataclasses

import numpy as np
import pytest
import torch

import scrooge_tpu_torch as st
from portbench import check, generate
from scrooge_tpu_torch.api import AlignStats
from scrooge_tpu_torch.ops import _cuda

W, K, O = 64, 64, 33


@pytest.fixture(scope="module")
def mix():
    """12 reads of ~500 bp, each with its true position and Poisson(1)
    decoys, on a 200 kbp genome; the reference's answer to every pair."""
    gen = generate.generator(2**31 + 11, "cpu")
    genome, gcodes = generate.make_genome([150_000, 50_000], gen, "cpu")
    rs = generate.make_reads(genome, gcodes, 12, 500, 0.95, (6, 55, 39),
                             1.0, gen)
    ref = check.align_reference(genome.content, rs,
                                np.arange(len(rs.pairs)), W, K, O)
    return genome, rs, ref


def _config():
    # one tile (and one readback chunk) of true and decoy lanes together
    return st.AlignConfig(W=W, K=K, O=O, store_entries_not_edges=True,
                          discard_entries_not_used_by_traceback=True,
                          early_termination=True, batch_tile=128)


def _check(mix, device):
    genome, rs, ref = mix
    out, stats = st.align_reads(genome, rs.reads, _config(),
                                return_stats=True, device=device)
    want = [(int(e), c) for e, c in zip(ref.eds.tolist(), ref.cigars)]
    assert check.answers(out, range(len(rs.pairs))) == want
    assert stats.retried_pairs == 0
    assert stats.runs == int(ref.runs.sum())
    # one word: a warp a pair, so no warp counters, and the row counters:
    # a window's first hit lies at or below its traced edits, and it spans
    # a pass of 32 rows at least
    assert stats.lane_work == stats.warp_work == 0
    assert stats.row_work >= int((ref.eds + ref.windows).sum())
    assert 32 * int(ref.windows.sum()) <= stats.row_slots
    assert stats.row_work <= stats.row_slots
    return stats


def test_the_mix_has_decoys(mix):
    _, rs, ref = mix
    n = len(rs.pairs)
    assert len(rs.reads) < n < 32
    # a decoy's text is unrelated: far more edits than a true pair's
    first = np.r_[True, rs.pairs[1:, 0] != rs.pairs[:-1, 0]]
    assert ref.eds[~first].min() > 4 * ref.eds[first].max()


def test_chained_mix_matches_the_reference(mix):
    _check(mix, "cpu")


@pytest.mark.parametrize("n, lane_work, warp_work", [
    # two full warps: lane w = ed + windows is 1..32, then 33..64
    (64, sum(range(1, 65)), 32 * 32 + 32 * 64),
    # a full warp and a last one of five lanes
    (37, sum(range(1, 38)), 32 * 32 + 5 * 37),
])
def test_warp_work_by_hand(n, lane_work, warp_work):
    s = AlignStats()
    eds = np.arange(n) // 2
    wused = np.arange(1, n + 1) - eds
    s.count_warp_work(eds, wused)
    assert (s.lane_work, s.warp_work) == (lane_work, warp_work)


def test_a_failed_lane_counts_no_edits():
    s = AlignStats()
    s.count_warp_work(np.array([-1, 3]), np.array([2, 4]))
    assert (s.lane_work, s.warp_work) == (9, 14)


def test_the_counters_survive_add():
    a = AlignStats(num_pairs=5, runs=7, row_slots=64, row_work=9,
                   lane_work=11, warp_work=13)
    b = AlignStats(num_pairs=3, runs=1, row_slots=32, row_work=3,
                   lane_work=2, warp_work=4)
    a.add(b)
    assert (a.num_pairs, a.runs, a.lane_work, a.warp_work) == (5, 8, 13, 17)
    assert (a.row_slots, a.row_work) == (96, 12)
    assert ("runs=8 row_slots=96 row_work=12 lane_work=13 warp_work=17"
            in a.breakdown())


def test_row_counters_add_over_tiles_and_shards():
    """A window's rows do not depend on its tile: ~280 pairs of 200 bp in
    three tiles of 128 on two shards count what one tile on one device
    counts."""
    gen = generate.generator(2**31 + 13, "cpu")
    genome, gcodes = generate.make_genome([100_000], gen, "cpu")
    rs = generate.make_reads(genome, gcodes, 140, 200, 0.95, (6, 55, 39),
                             1.0, gen)
    assert len(rs.pairs) > 256
    one_tile = dataclasses.replace(_config(), batch_tile=512)
    _, one = st.align_reads(genome, rs.reads, one_tile, return_stats=True,
                            device="cpu")
    _, many = st.align_reads(genome, rs.reads, _config(), return_stats=True,
                             device=["cpu", "cpu"])
    assert 0 < one.row_work < one.row_slots
    assert (many.row_slots, many.row_work) == (one.row_slots, one.row_work)


@pytest.mark.cuda
def test_chained_mix_on_the_card(mix):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kern = _cuda.GENASM_WINDOWS1
    before = kern.counts[1]
    card = _check(mix, "cuda")
    assert kern.counts[1] == before + 1
    # the kernel's row counters are the plain version's
    cpu = _check(mix, "cpu")
    assert (card.row_slots, card.row_work) == (cpu.row_slots, cpu.row_work)


def test_the_cpu_route_builds_no_tokens_on_the_kernel(mix):
    genome, rs, _ = mix
    kern = _cuda.GENASM_TOKENS
    before = kern.counts[0]
    _, stats = st.align_reads(genome, rs.reads[:3], _config(),
                              return_stats=True, device="cpu")
    assert kern.counts[0] == before and stats.runs > 0
