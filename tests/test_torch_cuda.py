"""The hand-written CUDA kernel against the plain torch engine, on a card.

Needs an NVIDIA GPU with nvcc (sm_90a); every test skips where
torch.cuda.is_available() is false. This file imports no JAX: the machine
with the card has none. Run there with
``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

import scrooge_tpu_torch as st
from scrooge_tpu_torch.ops import _cuda, compact, engine, pack
from scrooge_tpu_torch.tools import kernel_lab
from scrooge_tpu_torch.utils.simulate import edge_pairs, multiword_edge_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(seed, B, T, P, rate=0.08):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, (B, T), dtype=np.uint8)
    noise = rng.integers(0, 4, (B, P), dtype=np.uint8)
    pattern = np.where(rng.random((B, P)) < rate, noise,
                       text[:, :P]).astype(np.uint8)
    tlen = rng.integers(1, T + 1, B).astype(np.int32)
    plen = rng.integers(0, P + 1, B).astype(np.int32)
    return text, tlen, pattern, plen


def _same(a, b):
    """ed, failed and counts, then the runs after compaction."""
    for x, y in zip(a[:2] + a[3:4], b[:2] + b[3:4]):
        assert torch.equal(x.cpu(), y.cpu())
    cap = int(a.counts.sum(0).max().item()) + 1
    ca, ta = compact.compact_entries(a.entries, a.counts, cap)
    cb, tb = compact.compact_entries(b.entries, b.counts, cap)
    assert torch.equal(ta.cpu(), tb.cpu()) and torch.equal(ca.cpu(),
                                                            cb.cpu())


@pytest.mark.parametrize("wko", [(32, 32, 17), (64, 64, 33), (16, 16, 9),
                                 (64, 64, 2), (96, 96, 49), (128, 128, 65),
                                 (192, 192, 97), (256, 256, 129),
                                 (257, 257, 129), (320, 320, 161),
                                 (512, 512, 0), (1024, 1024, 513),
                                 (193, 193, 97), (256, 256, 0)])
def test_kernel_matches_plain(cuda, wko):
    W, K, O = wko
    cfg = st.AlignConfig(W=W, K=K, O=O)
    text, tlen, pattern, plen = _batch(W + O, 300, 400, 360)
    args = (pack.pack_2bit(torch.from_numpy(text)).to(cuda),
            torch.from_numpy(tlen).to(cuda),
            pack.pack_2bit(torch.from_numpy(pattern)).to(cuda),
            torch.from_numpy(plen).to(cuda))
    maxw = cfg.max_windows(360)
    nw = engine.num_words(W)
    kernel = engine.window_kernel(cfg)
    assert (kernel is _cuda.GENASM_WINDOWS1) == (W <= 64)
    before = kernel.counts[nw]
    got = engine.align_batch(cfg, maxw, *args)
    assert kernel.counts[nw] == before + 1
    B, Tw = args[0].shape
    base = torch.arange(B, dtype=torch.int64, device=cuda) * (Tw * 16)
    want = engine.align_windows_plain(cfg, maxw, args[0], base, *args[1:])
    torch.cuda.synchronize()
    _same(got, want)


@pytest.mark.parametrize("wko", [(64, 64, 33), (64, 16, 33),
                                 (128, 128, 65), (256, 64, 129),
                                 (512, 10, 257), (1024, 8, 0),
                                 (256, 12, 129)])
def test_kernel_without_early_termination_matches_plain(cuda, wko):
    """The instantiations without early termination (engine.ET_OFF in
    the key) on edge pairs: FAIL_TB lanes at the small K, and every row
    up to K filled after the first hit."""
    W, K, O = wko
    cfg = st.AlignConfig(W=W, K=K, O=O, early_termination=False)
    text, tlen, pattern, plen = edge_pairs(W + K, 100, 300, 280,
                                           cfg.tb_limit)
    args = (pack.pack_2bit(torch.from_numpy(text)).to(cuda),
            torch.from_numpy(tlen).to(cuda),
            pack.pack_2bit(torch.from_numpy(pattern)).to(cuda),
            torch.from_numpy(plen).to(cuda))
    maxw = cfg.max_windows(280)
    kernel, key = engine.window_kernel(cfg), engine.kernel_key(cfg)
    assert key == engine.num_words(W) | engine.ET_OFF
    before = kernel.counts[key]
    got = engine.align_batch(cfg, maxw, *args)
    assert kernel.counts[key] == before + 1
    B, Tw = args[0].shape
    base = torch.arange(B, dtype=torch.int64, device=cuda) * (Tw * 16)
    want = engine.align_windows_plain(cfg, maxw, args[0], base, *args[1:])
    torch.cuda.synchronize()
    _same(got, want)


@pytest.mark.parametrize("wko", [(64, 64, 33), (128, 128, 65),
                                 (256, 256, 129)])
def test_kernel_mapped_matches_plain(cuda, wko):
    W, K, O = wko
    cfg = st.AlignConfig(W=W, K=K, O=O)
    rng = np.random.default_rng(2)
    G, B, P = 20000, 256, 700
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    starts = rng.integers(0, G, B).astype(np.int64)
    pattern = np.where(rng.random((B, P)) < 0.05,
                       rng.integers(0, 4, (B, P), dtype=np.uint8),
                       genome[np.minimum(starts[:, None] + np.arange(P),
                                         G - 1)]).astype(np.uint8)
    plen = rng.integers(0, P + 1, B).astype(np.int32)
    maxw = -(-cfg.max_windows(P) // 32) * 32
    tlen = np.minimum(G - starts, maxw * cfg.tb_limit + cfg.W).astype(
        np.int32)
    args = (pack.pack_2bit(torch.from_numpy(genome)).to(cuda),
            torch.from_numpy(starts).to(cuda),
            torch.from_numpy(tlen).to(cuda),
            pack.pack_2bit(torch.from_numpy(pattern)).to(cuda),
            torch.from_numpy(plen).to(cuda))
    got = engine.align_windows(cfg, maxw, *args)
    want = engine.align_windows_plain(cfg, maxw, *args)
    torch.cuda.synchronize()
    _same(got, want)


# the configs of the CPU edge-case test in test_torch_engine.py: O = 2
# and O = 0 trace back 62 and 64 chars (65 stored columns), K = 16 fails
# the unrelated lanes
EDGE_CONFIGS = [(64, 64, 33), (48, 48, 25), (64, 64, 2), (64, 64, 0),
                (64, 16, 33)]


@pytest.mark.parametrize("wko", EDGE_CONFIGS)
def test_one_word_kernel_matches_plain_on_edge_pairs(cuda, wko):
    """The one-word kernel (genasm_windows1.cu) against the plain version,
    on the edge-case batches of the CPU test in test_torch_engine.py."""
    W, K, O = wko
    cfg = st.AlignConfig(W=W, K=K, O=O)
    kern = _cuda.GENASM_WINDOWS1
    assert engine.window_kernel(cfg) is kern
    text, tlen, pattern, plen = edge_pairs(W + O + K, 64, 300, 280,
                                           cfg.tb_limit)
    tw = pack.pack_2bit(torch.from_numpy(text)).to(cuda)
    base = torch.arange(64, dtype=torch.int64, device=cuda) * (
        tw.shape[1] * 16)
    args = (tw, base, torch.from_numpy(tlen).to(cuda),
            pack.pack_2bit(torch.from_numpy(pattern)).to(cuda),
            torch.from_numpy(plen).to(cuda))
    maxw = cfg.max_windows(280)
    before = kern.counts[1]
    got = engine.align_windows(cfg, maxw, *args)
    assert kern.counts[1] == before + 1
    want = engine.align_windows_plain(cfg, maxw, *args)
    torch.cuda.synchronize()
    if K == 16:
        assert int((want.failed == engine.FAIL_TB).sum()) > 0
    _same(got, want)


# the configs of the CPU multiword edge-case test in test_torch_engine.py
MULTIWORD_EDGE_CONFIGS = [(128, 128, 65), (96, 96, 49), (128, 128, 2),
                          (128, 128, 0), (130, 130, 66), (192, 192, 97),
                          (256, 256, 129), (128, 16, 65)]


@pytest.mark.parametrize("wko", MULTIWORD_EDGE_CONFIGS)
def test_multiword_kernel_matches_plain_on_edge_pairs(cuda, wko):
    """The multiword kernels (genasm_windows.cu at two and three words,
    genasm_windows_wide.cu at four) against the plain version, on the
    edge-case batches of the CPU test in test_torch_engine.py."""
    W, K, O = wko
    cfg = st.AlignConfig(W=W, K=K, O=O)
    kern = (_cuda.GENASM_WINDOWS if W <= 192 else
            _cuda.GENASM_WINDOWS_WIDE)
    assert engine.window_kernel(cfg) is kern
    text, tlen, pattern, plen = multiword_edge_batch(cfg)
    B, P = pattern.shape
    tw = pack.pack_2bit(torch.from_numpy(text)).to(cuda)
    base = torch.arange(B, dtype=torch.int64, device=cuda) * (
        tw.shape[1] * 16)
    args = (tw, base, torch.from_numpy(tlen).to(cuda),
            pack.pack_2bit(torch.from_numpy(pattern)).to(cuda),
            torch.from_numpy(plen).to(cuda))
    maxw = cfg.max_windows(P)
    nw = engine.num_words(W)
    before = kern.counts[nw]
    got = engine.align_windows(cfg, maxw, *args)
    assert kern.counts[nw] == before + 1
    want = engine.align_windows_plain(cfg, maxw, *args)
    torch.cuda.synchronize()
    if K == 16:
        assert int((want.failed == engine.FAIL_TB).sum()) > 0
    _same(got, want)


@pytest.mark.parametrize("nw, W", [(1, 64), (5, 320), (4, 320), (2, 64),
                                   (4, 256), (4, 193)])
def test_multiword_kernel_refuses_one_word_and_wide_windows(cuda, nw, W):
    """genasm_windows_launch takes NW = ceil(W/64) in 2..3 only: one word
    belongs to genasm_windows1.cu and W > 192 to genasm_windows_wide.cu. A refused
    launch raises and counts nothing; the entry point returns -1 before
    it reads any pointer."""
    kern = _cuda.GENASM_WINDOWS
    before = dict(kern.counts)
    with pytest.raises(RuntimeError, match="arguments refused"):
        # null pointers, B=2, K=W, O=W/2+1, 4 windows
        kern.launch(nw, None, 4, None, None, None, 4, None, 2, W, W,
                    W // 2 + 1, 4, None, None, None, None, None, None,
                    None)
    assert dict(kern.counts) == before


@pytest.mark.parametrize("wko", [(512, 512, 257), (2048, 2048, 1025),
                                 (256, 256, 129)])
def test_wide_kernel_split_launches_match_one(cuda, wko):
    """A tile split into five launches by a small scratch budget (12
    pairs a launch, the last 2) gives the one launch's outputs; W=2048
    (G = 32) takes 273 MB of R a pair, so a tile of a few hundred pairs
    splits by itself. At W=256 (G = 4) a launch's lanes come a pair at a
    time too (pairs_per_warp 1), not in warps of 32 pairs."""
    W, K, O = wko
    cfg = st.AlignConfig(W=W, K=K, O=O)
    text, tlen, pattern, plen = _batch(9, 50, 900, 800)
    tw = pack.pack_2bit(torch.from_numpy(text)).to(cuda)
    base = torch.arange(50, dtype=torch.int64, device=cuda) * (
        tw.shape[1] * 16)
    args = (tw, base, torch.from_numpy(tlen).to(cuda),
            pack.pack_2bit(torch.from_numpy(pattern)).to(cuda),
            torch.from_numpy(plen).to(cuda))
    maxw = cfg.max_windows(800)
    one = engine.align_windows(cfg, maxw, *args)
    budget = 8 * sum(engine.scratch_words(cfg, 12))
    assert len(engine.launch_chunks(cfg, 50, budget)) == 5
    kern, nw = _cuda.GENASM_WINDOWS_WIDE, engine.num_words(W)
    assert engine.window_kernel(cfg) is kern
    assert engine.pairs_per_warp(cfg) == 1
    before = kern.counts[nw]
    split = engine._align_windows_cuda(cfg, maxw, *args, budget_bytes=budget)
    assert kern.counts[nw] == before + 5
    torch.cuda.synchronize()
    _same(split, one)
    with pytest.raises(MemoryError):
        engine._align_windows_cuda(cfg, maxw, *args, budget_bytes=1024)


@pytest.mark.parametrize("nw, W", [(3, 192), (1, 64), (33, 2100),
                                   (6, 320), (4, 320), (5, 256)])
def test_wide_kernel_refuses_other_word_counts(cuda, nw, W):
    """genasm_windows_wide_launch takes NW = ceil(W/64) in 4..32 only and
    returns -1 before it reads any pointer; nothing is counted."""
    kern = _cuda.GENASM_WINDOWS_WIDE
    before = dict(kern.counts)
    with pytest.raises(RuntimeError, match="arguments refused"):
        kern.launch(nw, None, 4, None, None, None, 4, None, 2, W, W,
                    W // 2 + 1, 4, None, None, None, None, None, None,
                    None)
    assert dict(kern.counts) == before


@pytest.mark.parametrize("et", [True, False], ids=["eton", "etoff"])
def test_w256_tiles_launch_the_wide_kernel(cuda, et):
    """align_reads at W=256 K=256 O=129 in three tiles: one launch of
    genasm_windows_wide.cu a tile at key 4 (4 | ET_OFF without early
    termination), none of genasm_windows.cu; the alignments equal the
    CPU's."""
    from scrooge_tpu_torch import bench
    from scrooge_tpu_torch.utils.simulate import simulate_dataset

    ds = simulate_dataset(genome_len=100_000, num_reads=300, read_len=2000,
                          accuracy=0.95, seed=6)
    cfg = st.AlignConfig(W=256, K=256, O=129, batch_tile=128,
                         early_termination=et)
    key = engine.kernel_key(cfg)
    assert key == (4 if et else 4 | engine.ET_OFF)
    before = bench.launches()
    got = st.align_reads(ds.genome, ds.reads, cfg, device=cuda)
    assert bench.since(before) == {_cuda.GENASM_WINDOWS_WIDE.source: {key: 3}}
    assert got[:24] == st.align_reads(ds.genome, ds.reads[:24], cfg,
                                      device="cpu")


@pytest.mark.parametrize("et", [True, False], ids=["eton", "etoff"])
@pytest.mark.parametrize("wko", [(16, 16, 9), (32, 32, 17), (64, 64, 33)],
                         ids=lambda w: "-".join(map(str, w)))
def test_one_word_kernel_matches_plain_on_chained_pairs(cuda, wko, et):
    """The one-word kernel (a warp a pair) against plain on 600 pairs,
    half true (5 % edits) and half decoys on unrelated text, as chained
    candidates mix them: every output and the row counters."""
    from torch_window_harness import ragged_batch

    W, K, O = wko
    cfg = st.AlignConfig(W=W, K=K, O=O, early_termination=et)
    args = [a.to(cuda) for a in ragged_batch(W + 31, 600, 1600, 1400,
                                             unrelated=300, rate=0.05)]
    maxw = cfg.max_windows(int(args[4].max()))
    got = engine.align_windows(cfg, maxw, *args)
    want = engine.align_windows_plain(cfg, maxw, *args)
    assert int((want.failed == 0).sum()) > 500
    _same(got, want)
    assert torch.equal(got.rows.cpu(), want.rows.cpu())
    assert 0 < int(want.rows[1]) < int(want.rows[0])


@pytest.mark.parametrize("et", [True, False], ids=["eton", "etoff"])
@pytest.mark.parametrize("wko", [(32, 32, 17), (64, 64, 33)],
                         ids=lambda w: "-".join(map(str, w)))
def test_one_word_tiles_launch_only_the_one_word_kernel(cuda, wko, et):
    """align_reads at W <= 64 in three tiles: one launch of
    genasm_windows1.cu a tile at key 1 (257 without early termination)
    and the token kernel's one a tile, nothing else; the alignments equal
    the CPU's, and so do the row counters."""
    from scrooge_tpu_torch import bench
    from scrooge_tpu_torch.utils.simulate import simulate_dataset

    W, K, O = wko
    ds = simulate_dataset(genome_len=100_000, num_reads=300, read_len=600,
                          accuracy=0.95, seed=W)
    cfg = st.AlignConfig(W=W, K=K, O=O, batch_tile=128,
                         early_termination=et)
    key = engine.kernel_key(cfg)
    assert key == (1 if et else 1 | engine.ET_OFF)
    before = bench.launches()
    got, stats = st.align_reads(ds.genome, ds.reads, cfg, device=cuda,
                                return_stats=True)
    assert bench.since(before) == {_cuda.GENASM_WINDOWS1.source: {key: 3},
                                   _cuda.GENASM_TOKENS.source: {0: 3}}
    want, cpu = st.align_reads(ds.genome, ds.reads, cfg, device="cpu",
                               return_stats=True)
    assert got == want
    assert (stats.row_slots, stats.row_work) == (cpu.row_slots,
                                                 cpu.row_work)
    assert 0 < stats.row_work < stats.row_slots


def test_one_word_kernel_refuses_wide_windows(cuda):
    """A refused launch raises and counts nothing: the entry point takes
    W <= 64 only and returns -1 before it reads any pointer."""
    kern = _cuda.GENASM_WINDOWS1
    before = kern.counts[1]
    with pytest.raises(RuntimeError, match="arguments refused"):
        # null pointers, B=2, W=128 K=128 O=65, 4 windows
        kern.launch(1, None, 4, None, None, None, 4, None, 2, 128, 128, 65,
                    4, None, None, None, None, None, None)
    assert kern.counts[1] == before


def test_api_on_cuda(cuda):
    a = st.align_pairs(["AAAACCCCGGGGTTTT"], ["CCCCGGGGTTTTAAAA"],
                       device=cuda)
    assert (a[0].edit_distance, a[0].cigar) == (8, "4D12=4I")
    texts = ["ACGTTGCA" * 40, "GATTACA" * 30, "A" * 50]
    queries = [texts[0][3:300], texts[1][:150] + "GG", ""]
    on_card = st.align_pairs(texts, queries, device=cuda)
    assert on_card == st.align_pairs(texts, queries, device="cpu")


def test_w128_uint8_readback_packed_equals_strings_on_cuda(cuda):
    """At W=128 O=65 (tb_limit 63) the runs come back from the card as
    one byte an entry: packed equals strings, both equal the CPU's, and
    readback_bytes is the tile's most runs times its lanes."""
    from scrooge_tpu_torch.utils.simulate import simulate_dataset

    ds = simulate_dataset(genome_len=100_000, num_reads=300, read_len=2000,
                          accuracy=0.95, seed=5)
    cfg = st.AlignConfig(W=128, K=128, O=65, batch_tile=512)
    kern = _cuda.GENASM_WINDOWS
    before = kern.counts[2]
    strs, stats = st.align_reads(ds.genome, ds.reads, cfg, return_stats=True,
                                 device=cuda)
    packed, pstats = st.align_reads(ds.genome, ds.reads, cfg,
                                    return_stats=True, return_packed=True,
                                    device=cuda)
    assert kern.counts[2] - before == 2
    assert packed.to_alignments() == strs
    assert strs[:40] == st.align_reads(ds.genome, ds.reads[:40], cfg,
                                       device="cpu")
    assert stats.retried_pairs == 0
    entries = int(np.diff(packed.run_offsets).max()) * len(strs)
    assert stats.readback_bytes == pstats.readback_bytes == entries


def test_mesh_on_one_card_equals_one_device(cuda):
    """Two shards on two streams of one card (and a shard of each tile
    per card where there are more) give the one-device outputs, in
    strings and packed, with one launch a shard a tile."""
    from scrooge_tpu_torch.utils.simulate import simulate_dataset

    ds = simulate_dataset(genome_len=100_000, num_reads=300, read_len=2000,
                          accuracy=0.95, seed=3)
    cfg = st.AlignConfig(batch_tile=256)  # tiles of 256 and 44
    one = st.align_reads(ds.genome, ds.reads, cfg, device="cuda:0")
    assert one[:40] == st.align_reads(ds.genome, ds.reads[:40], cfg,
                                      device="cpu")
    kern = _cuda.GENASM_WINDOWS1
    for mesh in (["cuda:0", "cuda:0"], "cuda"):
        shards = 2 if mesh != "cuda" else torch.cuda.device_count()
        before = kern.counts[1]
        got, stats = st.align_reads(ds.genome, ds.reads, cfg,
                                    return_stats=True, device=mesh)
        assert got == one and stats.num_pairs == 300
        assert kern.counts[1] - before == 2 * shards
        packed = st.align_reads(ds.genome, ds.reads, cfg, return_packed=True,
                                device=mesh)
        assert packed.to_alignments() == one


@pytest.mark.parametrize("wko", [(64, 64, 33), (128, 128, 65)])
def test_tile_pipeline_on_cuda_equals_one_tile(cuda, monkeypatch, wko):
    """Tiles of 128 (a worker thread, two streams in turn), uploads and
    readbacks in several chunks, on one card and on two shards of it:
    the single-tile call's alignments, strings and packed, with one
    launch a tile (a shard) and no thread left behind."""
    import threading

    from scrooge_tpu_torch import api
    from scrooge_tpu_torch.utils.simulate import simulate_dataset

    W, K, O = wko
    ds = simulate_dataset(genome_len=100_000, num_reads=600, read_len=1500,
                          accuracy=0.95, seed=4)
    one = st.align_reads(ds.genome, ds.reads,
                         st.AlignConfig(W=W, K=K, O=O, batch_tile=1024),
                         device="cuda:0")
    monkeypatch.setattr(api, "UPLOAD_CHUNK_ROWS", 40)
    monkeypatch.setattr(api, "READBACK_CHUNK_LANES", 16)
    cfg = st.AlignConfig(W=W, K=K, O=O, batch_tile=128)  # five tiles
    kern = engine.window_kernel(cfg)
    nw = engine.num_words(W)
    threads = threading.active_count()
    for mesh, shards in (("cuda:0", 1), (["cuda:0", "cuda:0"], 2)):
        before = kern.counts[nw]
        got = st.align_reads(ds.genome, ds.reads, cfg, device=mesh)
        assert got == one
        assert kern.counts[nw] - before == 5 * shards
        packed = st.align_reads(ds.genome, ds.reads, cfg,
                                return_packed=True, device=mesh)
        assert packed.to_alignments() == one
    assert threading.active_count() == threads


def test_mesh_engine_and_small_budgets_change_no_output(cuda):
    """align_batch_on_mesh on two shards of one card against one launch
    at W=512, and align_reads with a scratch budget that splits every
    shard's launch."""
    from scrooge_tpu_torch.parallel import mesh as M

    cfg = st.AlignConfig(W=512, K=512, O=257)
    text, tlen, pattern, plen = _batch(11, 50, 900, 800)
    host = (pack.pack_2bit(torch.from_numpy(text)), torch.from_numpy(tlen),
            pack.pack_2bit(torch.from_numpy(pattern)),
            torch.from_numpy(plen))
    maxw = cfg.max_windows(800)
    whole = engine.align_batch(cfg, maxw, *(t.to(cuda) for t in host))
    for s in M.align_batch_on_mesh(cfg, maxw, ["cuda:0", "cuda:0"], *host):
        idx = torch.from_numpy(s.lanes).to(cuda)
        _same(s.result, engine.BatchResult(
            whole.edit_distance[idx], whole.failed[idx],
            whole.entries[:, :, idx], whole.counts[:, idx]))
    texts = ["".join("ACGT"[c] for c in row[: tlen[b]])
             for b, row in enumerate(text)]
    genome = st.Genome(content="".join(texts))
    starts = np.cumsum([0] + [len(t) for t in texts[:-1]])
    reads = [st.Read(description=f"r{b}",
                     content="".join("ACGT"[c] for c in pattern[b, : plen[b]]),
                     locations=[st.CandidateLocation(
                         start_in_reference=int(starts[b]))])
             for b in range(50)]
    want = st.align_reads(genome, reads, cfg, device="cuda:0")
    kern, nw = _cuda.GENASM_WINDOWS_WIDE, engine.num_words(cfg.W)
    before = kern.counts[nw]
    got = st.align_reads(genome, reads, cfg, device=["cuda:0", "cuda:0"],
                         budget_bytes=8 * sum(engine.scratch_words(cfg, 8)))
    assert got == want
    assert kern.counts[nw] - before >= 6  # 25 pairs a shard, 8 a launch


@pytest.mark.parametrize("case", [(31, 64, 2048, True)]
                         + [(m, n, 2048, False) for m, n in
                            kernel_lab.MN_CASES]
                         + [(None, None, 100, False)],
                         ids=lambda c: "m{}-n{}-B{}".format(*c[:3])
                         + ("-n40every7" if c[3] else ""))
@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
def test_fill_lab_kernel_matches_plain(cuda, variant, case):
    """The lane-group kernel against run_plain on the lab's inputs with
    n = 40 in every 7th lane, the (m, n) cases and a ragged batch (the
    first 100 lanes: a part-filled last block): wed, the sums and, in
    full, the rows of R both must store; it allocates no forefront
    scratch."""
    m_case, n_case, B, n40 = case
    m, n, pmi = (t.to(cuda) for t in kernel_lab.from_lab_layout(
        *kernel_lab.lab_inputs(2048, 0, m_case, n_case)))
    if n40:
        n[::7] = 40  # start columns inside the window for some lanes
    m, n, pmi = m[:B].contiguous(), n[:B].contiguous(), pmi[:, :B].contiguous()
    key = kernel_lab.VARIANTS.index(variant)
    kernel_lab.run(variant, 1, m, n, pmi, device=cuda)  # build
    torch.cuda.synchronize()
    before = _cuda.GENASM_FILL_LAB.counts[key]
    held = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    got = kernel_lab.run(variant, 3, m, n, pmi, device=cuda)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated(cuda) - held
    want = kernel_lab.run_plain(variant, 3, m, n, pmi)
    assert _cuda.GENASM_FILL_LAB.counts[key] == before + 1
    assert torch.equal(got.wed.cpu(), want.wed.cpu())
    assert int(got.total) == int(want.total)
    assert (got.R is None) == (variant != "full")
    if variant == "full":
        assert kernel_lab.r_mismatches(got, want) == 0
    # R (full only), wed, the per-lane sums and their total; a forefront
    # would add (W+1) * B words
    R = (kernel_lab.K + 1) * kernel_lab.COLS * B * 8
    assert scratch <= (R if variant == "full" else 0) + 12 * B + 4 * 512


def test_bench_on_cuda(cuda, monkeypatch, capsys):
    """The bench's main() on the card at 1,024 reads of 2 kbp: its
    kernel-only samples come from the one-word kernel, its value is
    positive, and its line holds every key of the card's line."""
    import json
    import os

    from scrooge_tpu_torch import bench
    from scrooge_tpu_torch.profiling import kernel_time

    for name in [n for n in os.environ if n.startswith("BENCH_")]:
        monkeypatch.delenv(name)
    for name, value in {"BENCH_READS": "1024", "BENCH_READ_LEN": "2000",
                        "BENCH_GENOME": "200000",
                        "BENCH_TILE": "1024"}.items():
        monkeypatch.setenv(name, value)
    one = _cuda.GENASM_WINDOWS1
    seen = []
    samples = kernel_time.kernel_rate_samples

    def counted(staged, reps, groups):
        before = one.counts[1]
        out = samples(staged, reps, groups)
        seen.append((one.counts[1] - before, len(out)))
        return out

    monkeypatch.setattr(kernel_time, "kernel_rate_samples", counted)
    assert bench.main() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # one warm-up call, then reps calls in each group
    assert seen == [(1 + bench.KERNEL_REPS * bench.KERNEL_GROUPS,
                     bench.KERNEL_GROUPS)]
    assert set(line) == {*bench.KEYS, *bench.CARD_KEYS, *bench.LONG_READ_KEYS}
    assert line["value"] > 0 and line["metric"] == (
        "long_read_aligns_per_second")
    assert (line["kernel_aligns_min"] <= line["value"]
            <= line["kernel_aligns_max"])
    assert line["card"] != "cpu"


def _tokens_equal_on_card(entries, counts, ne3c=0):
    """The token kernel (ops/tokens.lane_tokens on the card) against the
    torch route on the CPU, byte for byte over whole rows; one launch."""
    from scrooge_tpu_torch.ops import tokens

    totals = counts.cpu().clamp(0, entries.shape[1]).sum(0)
    cap = max(int(totals.max()), 1)
    kern = _cuda.GENASM_TOKENS
    before = kern.counts[0]
    got, got_tot = tokens.lane_tokens(entries.cuda(), counts.cuda(), cap)
    torch.cuda.synchronize()
    assert kern.counts[0] == before + 1
    want, want_tot = tokens.lane_tokens_plain(entries.cpu(), counts.cpu(),
                                              cap, ne3c)
    assert torch.equal(got_tot.cpu(), want_tot)
    assert torch.equal(got.cpu(), want)
    return want_tot


@pytest.mark.parametrize("seed, wcap, B, max_count", [
    (1, 40, 1024, 31), (2, 100, 77, 31), (3, 1, 33, 63), (4, 480, 256, 31),
    (5, 70, 130, 4095)])
def test_token_kernel_matches_torch_route_on_random_layouts(cuda, seed, wcap,
                                                            B, max_count):
    from torch_window_harness import random_layout

    entries, counts = random_layout(seed, wcap, B, max_count=max_count)
    counts[:, 3 % B] = 0  # a lane with no runs
    _tokens_equal_on_card(torch.from_numpy(entries),
                          torch.from_numpy(counts))


def test_token_kernel_matches_torch_route_on_chained_pairs(cuda):
    """The window kernel's results at 64/64/33 on 1,024 pairs, half of
    them true (indels and substitutions at 5 %) and half decoys
    (unrelated), as a chained tile mixes them."""
    from torch_window_harness import ragged_batch

    cfg = st.AlignConfig(W=64, K=64, O=33)
    args = ragged_batch(21, 1024, 2400, 2000, unrelated=512, rate=0.05)
    maxw = cfg.max_windows(int(args[4].max()))
    res = engine.align_windows(cfg, maxw, *(a.to(cuda) for a in args))
    meta = compact.batch_meta(res).cpu().numpy()
    assert int((meta[2] == 0).sum()) > 1000
    wcap = max(int(meta[4].max()), 1)
    tot = _tokens_equal_on_card(res.entries[:wcap], res.counts[:wcap],
                                int(meta[3].max()))
    # decoys give several times a true pair's tokens
    assert tot[-512:].float().mean() > 3 * tot[8:512].float().mean()


def test_align_reads_token_kernel_equals_cpu(cuda):
    """align_reads on a chained mix (true candidates and Poisson(1) decoys)
    in tiles of 128: strings and packed equal the CPU's, and every tile's
    tokens came from the kernel, one launch a tile."""
    from portbench import generate

    gen = generate.generator(2**31 + 23, "cpu")
    genome, gcodes = generate.make_genome([150_000, 50_000], gen, "cpu")
    rs = generate.make_reads(genome, gcodes, 200, 300, 0.95, (6, 55, 39),
                             1.0, gen)
    cfg = st.AlignConfig(W=64, K=64, O=33, batch_tile=128)
    tiles = -(-len(rs.pairs) // 128)
    assert tiles >= 3
    want = st.align_reads(genome, rs.reads, cfg, device="cpu")
    kern = _cuda.GENASM_TOKENS
    for packed in (False, True):
        before = kern.counts[0]
        got = st.align_reads(genome, rs.reads, cfg, return_packed=packed,
                             device=cuda)
        assert (got.to_alignments() if packed else got) == want
        assert kern.counts[0] - before == tiles
    # the runs' route (tb_limit > 31) does not take it
    before = kern.counts[0]
    st.align_reads(genome, rs.reads[:4], st.AlignConfig(W=128, K=128, O=65),
                   device=cuda)
    assert kern.counts[0] == before


def test_token_kernel_refuses_wide_windows_and_other_layouts(cuda):
    from scrooge_tpu_torch.ops import tokens

    entries = torch.zeros((3, 66, 8), dtype=torch.int16, device=cuda)
    counts = torch.zeros((3, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="arguments refused"):
        tokens.lane_tokens(entries, counts, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tokens.lane_tokens(entries[:, :64].transpose(0, 1), counts, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tokens.lane_tokens(entries[:, :64], counts.to(torch.int64), 4)
