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
                                 (512, 512, 0), (1024, 1024, 513)])
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
    """The multiword kernel (genasm_windows.cu) against the plain version,
    on the edge-case batches of the CPU test in test_torch_engine.py."""
    W, K, O = wko
    cfg = st.AlignConfig(W=W, K=K, O=O)
    kern = _cuda.GENASM_WINDOWS
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


@pytest.mark.parametrize("nw, W", [(1, 64), (5, 320), (4, 320), (2, 64)])
def test_multiword_kernel_refuses_one_word_and_wide_windows(cuda, nw, W):
    """genasm_windows_launch takes NW = ceil(W/64) in 2..4 only: one word
    belongs to genasm_windows1.cu and W > 256 to genasm_windows_wide.cu. A refused
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


@pytest.mark.parametrize("wko", [(512, 512, 257), (2048, 2048, 1025)])
def test_wide_kernel_split_launches_match_one(cuda, wko):
    """A tile split into five launches by a small scratch budget (a
    part-filled last warp among them at W=512) gives the one launch's
    outputs; W=2048 (G = 32) takes 269 MB of R a pair, so a tile of a few
    hundred pairs splits by itself."""
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
    before = kern.counts[nw]
    split = engine._align_windows_cuda(cfg, maxw, *args, budget_bytes=budget)
    assert kern.counts[nw] == before + 5
    torch.cuda.synchronize()
    _same(split, one)
    with pytest.raises(MemoryError):
        engine._align_windows_cuda(cfg, maxw, *args, budget_bytes=1024)


@pytest.mark.parametrize("nw, W", [(4, 256), (1, 64), (33, 2100),
                                   (6, 320)])
def test_wide_kernel_refuses_other_word_counts(cuda, nw, W):
    """genasm_windows_wide_launch takes NW = ceil(W/64) in 5..32 only and
    returns -1 before it reads any pointer; nothing is counted."""
    kern = _cuda.GENASM_WINDOWS_WIDE
    before = dict(kern.counts)
    with pytest.raises(RuntimeError, match="arguments refused"):
        kern.launch(nw, None, 4, None, None, None, 4, None, 2, W, W,
                    W // 2 + 1, 4, None, None, None, None, None, None,
                    None)
    assert dict(kern.counts) == before


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
