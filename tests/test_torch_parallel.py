"""The port's mesh (scrooge_tpu_torch/parallel/mesh.py) on CPU shards.

``["cpu"] * k`` runs the sharded code (a thread and a plain engine a
shard) on the CPU. Its outputs are held exactly to the port on one
device and to the JAX package's ``align_all(..., backend="xla")``; the
device rules (indexed keys, no fallback) and the thread-safe launch
counter are checked here too. Inputs come from seeded ``random`` and
numpy; every comparison is exact equality.
"""

import random
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scrooge_tpu  # noqa: E402
import scrooge_tpu_torch as st  # noqa: E402
from scrooge_tpu import pyref  # noqa: E402
from scrooge_tpu.config import AlignConfig as JaxAlignConfig  # noqa: E402
from scrooge_tpu.datamodel import (CandidateLocation as JaxLoc,  # noqa: E402
                                   Genome as JaxGenome, Read as JaxRead)
from scrooge_tpu_torch import (AlignConfig, AlignmentError,  # noqa: E402
                               CandidateLocation, Genome, Read, api)
from scrooge_tpu_torch.ops import _cuda, engine, pack  # noqa: E402
from scrooge_tpu_torch.parallel import mesh as M  # noqa: E402
from scrooge_tpu_torch.utils.simulate import simulate_dataset  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401


def _pairs(seed, count, lo=40, hi=160, rate=0.04):
    """(texts, queries): reads cut from their texts with substitutions,
    insertions and deletions at ``rate`` each."""
    rng = random.Random(seed)
    texts, queries = [], []
    for _ in range(count):
        t = "".join(rng.choice("ACGT") for _ in range(rng.randint(lo, hi)))
        q = []
        for c in t[: rng.randint(lo // 2, len(t))]:
            r = rng.random()
            if r < rate:
                continue
            q.append(rng.choice("ACGT") if r < 2 * rate else c)
            if r > 1 - rate:
                q.append(rng.choice("ACGT"))
        texts.append(t)
        queries.append("".join(q))
    return texts, queries


def _key(alns):
    return [(a.edit_distance, a.cigar) for a in alns]


def _jax_pairs(texts, queries, W, K, O, tile):
    cfg = JaxAlignConfig(W=W, K=K, O=O, backend="xla", batch_tile=tile)
    return _key(scrooge_tpu.align_all(texts, queries, config=cfg))


@pytest.fixture(scope="module")
def pairs203():
    """203 pairs of 15..110 bp at W=64 with a tile of 128: tiles of 128
    and 75, which 2, 3 and 8 do not all divide; and the JAX package's
    result."""
    texts, queries = _pairs(3, 203, lo=30, hi=110)
    return texts, queries, _jax_pairs(texts, queries, 64, 64, 33, 128)


@pytest.mark.parametrize("k", [2, 3, 8])
def test_align_pairs_on_mesh_equals_one_device_and_jax(pairs203, k):
    texts, queries, want = pairs203
    cfg = AlignConfig(batch_tile=128)
    one = st.align_pairs(texts, queries, cfg, device="cpu")
    assert _key(one) == want
    mesh = ["cpu"] * k
    got, stats = st.align_pairs(texts, queries, cfg, return_stats=True,
                                device=mesh)
    assert _key(got) == want
    assert stats.num_pairs == 203 and stats.retried_pairs == 0
    assert stats.core_ns > 0 and stats.upload_bytes > 0
    packed = st.align_pairs(texts, queries, cfg, return_packed=True,
                            device=mesh)
    single = st.align_pairs(texts, queries, cfg, return_packed=True,
                            device="cpu")
    assert packed.to_alignments() == one
    np.testing.assert_array_equal(packed.edit_distances,
                                  single.edit_distances)
    np.testing.assert_array_equal(packed.run_offsets, single.run_offsets)
    np.testing.assert_array_equal(packed.runs, single.runs)


@pytest.mark.parametrize("n", [0, 1, 5])
def test_fewer_lanes_than_shards(pairs203, n):
    texts, queries, want = pairs203
    cfg = AlignConfig(batch_tile=128)
    got = st.align_pairs(texts[:n], queries[:n], cfg, device=["cpu"] * 8)
    assert _key(got) == want[:n]
    packed = st.align_pairs(texts[:n], queries[:n], cfg, return_packed=True,
                            device=["cpu"] * 8)
    assert packed.to_alignments() == got
    assert len(packed.run_offsets) == n + 1


@pytest.mark.parametrize("wko,k,count", [((128, 128, 65), 3, 12),
                                         ((512, 512, 257), 2, 4)])
def test_wide_windows_on_mesh(wko, k, count):
    """Two words (W=128) and the wide engine (W=512), 130..420 bp."""
    W, K, O = wko
    texts, queries = _pairs(W, count, lo=260, hi=420)
    want = _jax_pairs(texts, queries, W, K, O, 128)
    cfg = AlignConfig(W=W, K=K, O=O, batch_tile=128)
    assert _key(st.align_pairs(texts, queries, cfg, device="cpu")) == want
    got = st.align_pairs(texts, queries, cfg, device=["cpu"] * k)
    assert _key(got) == want
    packed = st.align_pairs(texts, queries, cfg, return_packed=True,
                            device=["cpu"] * k)
    assert _key(packed.to_alignments()) == want


@pytest.fixture(scope="module")
def mapped():
    """130 reads of 120 bp on a 30 kbp genome, every third with a second
    candidate location a few bases off the first (174 pairs, two tiles of
    128), and the JAX package's result."""
    ds = simulate_dataset(genome_len=30_000, num_reads=130, read_len=120,
                          accuracy=0.95, seed=9)
    rng = random.Random(9)
    reads = []
    for i, r in enumerate(ds.reads):
        locs = list(r.locations)
        if i % 3 == 0:
            start = locs[0].start_in_reference + rng.randint(-6, 6)
            locs.append(CandidateLocation(start_in_reference=max(start, 0)))
        reads.append(Read(description=r.description, content=r.content,
                          locations=locs))
    jreads = [JaxRead(description=r.description, content=r.content,
                      locations=[JaxLoc(start_in_reference=l.start_in_reference)
                                 for l in r.locations]) for r in reads]
    want = _key(scrooge_tpu.align_all(
        JaxGenome(content=ds.genome.content), jreads,
        config=JaxAlignConfig(backend="xla", batch_tile=128)))
    return ds.genome, reads, want


@pytest.mark.parametrize("k", [2, 3, 8])
def test_align_reads_on_mesh_equals_one_device_and_jax(mapped, k):
    genome, reads, want = mapped
    cfg = AlignConfig(batch_tile=128)
    assert len(want) == 174
    assert _key(st.align_reads(genome, reads, cfg, device="cpu")) == want
    prepared = st.prepare_genome(genome)
    got = st.align_reads(prepared, reads, cfg, device=["cpu"] * k)
    assert _key(got) == want
    packed = st.align_reads(prepared, reads, cfg, return_packed=True,
                            device=["cpu"] * k)
    assert _key(packed.to_alignments()) == want
    # one replica of the genome a distinct device
    assert list(prepared._dev) == [torch.device("cpu")]


@pytest.mark.parametrize("packed", [False, True])
def test_failed_lanes_on_mesh_are_retried_on_pyref(monkeypatch, packed):
    """Lanes a shard's engine fails go to the scalar oracle and come back
    exact in pair order, counted once in the call's stats."""
    real = engine.align_batch

    def failing(*args, **kwargs):
        res = real(*args, **kwargs)
        res.failed[::2] |= engine.FAIL_INCOMPLETE
        return res

    monkeypatch.setattr(engine, "align_batch", failing)
    texts, queries = _pairs(41, 11, hi=120)
    cfg = AlignConfig()
    out, stats = st.align_pairs(texts, queries, cfg, return_stats=True,
                                return_packed=packed, device=["cpu"] * 3)
    got = out.to_alignments() if packed else out
    assert _key(got) == [pyref.align_pair(t, q, cfg)
                         for t, q in zip(texts, queries)]
    # shards of 4, 4 and 3 lanes, each failing its lanes 0 and 2
    assert stats.retried_pairs == stats.fail_incomplete_pairs == 6


def test_unalignable_pair_on_mesh_raises_as_jax_does():
    """K below the edits: the lane fails on its shard and pyref raises,
    as on one device and in the JAX package."""
    texts = ["A" * 40, "ACGT" * 10, "C" * 40]
    queries = ["A" * 39, "ACGT" * 10, "G" * 40]
    cfg = AlignConfig(W=32, K=4, O=17)
    for device in ("cpu", ["cpu"] * 2, ["cpu"] * 3):
        with pytest.raises(AlignmentError, match="pair 2"):
            st.align_pairs(texts, queries, cfg, device=device)
    with pytest.raises(scrooge_tpu.api.AlignmentError):
        scrooge_tpu.align_all(texts, queries, config=JaxAlignConfig(
            W=32, K=4, O=17, backend="xla"))
    assert _key(st.align_pairs(texts[:2], queries[:2], cfg,
                               device=["cpu"] * 2)) == [
        pyref.align_pair(t, q, cfg) for t, q in zip(texts[:2], queries[:2])]


def test_one_device_runs_no_thread(monkeypatch, pairs203):
    """A mesh of one device (given alone or as a list of one) launches
    its tiles on the caller's thread; a mesh of two on shard threads."""
    real, seen = engine.align_batch, []

    def recording(*args, **kwargs):
        seen.append(threading.get_ident())
        return real(*args, **kwargs)

    monkeypatch.setattr(engine, "align_batch", recording)
    texts, queries, want = pairs203
    cfg = AlignConfig(batch_tile=128)
    me = threading.get_ident()
    for device in ("cpu", ["cpu"], torch.device("cpu")):
        seen.clear()
        assert _key(st.align_pairs(texts[:20], queries[:20], cfg,
                                   device=device)) == want[:20]
        assert seen == [me], device
    seen.clear()
    assert _key(st.align_pairs(texts[:20], queries[:20], cfg,
                               device=["cpu"] * 2)) == want[:20]
    assert len(seen) == 2 and me not in seen


def _batch(seed, B, T=240, P=200):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, (B, T), dtype=np.uint8)
    pattern = np.where(rng.random((B, P)) < 0.06,
                       rng.integers(0, 4, (B, P), dtype=np.uint8),
                       text[:, :P]).astype(np.uint8)
    tlen = rng.integers(P // 2, T + 1, B).astype(np.int32)
    plen = rng.integers(0, P + 1, B).astype(np.int32)
    return (pack.pack_2bit(torch.from_numpy(text)), torch.from_numpy(tlen),
            pack.pack_2bit(torch.from_numpy(pattern)),
            torch.from_numpy(plen))


def _assert_shards_equal(shards, whole, B):
    assert sorted(np.concatenate([s.lanes for s in shards]).tolist()) == \
        list(range(B))
    for s in shards:
        idx = torch.from_numpy(s.lanes)
        assert torch.equal(s.result.edit_distance, whole.edit_distance[idx])
        assert torch.equal(s.result.failed, whole.failed[idx])
        assert torch.equal(s.result.counts, whole.counts[:, idx])
        assert torch.equal(s.result.entries, whole.entries[:, :, idx])


@pytest.mark.parametrize("k,B", [(3, 37), (8, 6)])
def test_engine_level_mesh_equals_engine(k, B):
    """align_batch_on_mesh and align_batch_mapped_on_mesh against
    engine.align_batch / align_windows on ed, failed, entries and counts;
    8 shards of 6 lanes leave two empty."""
    cfg = AlignConfig(W=64, K=64, O=33)
    tw, tlen, pw, plen = _batch(7, B)
    maxw = 8
    whole = engine.align_batch(cfg, maxw, tw, tlen, pw, plen)
    shards = M.align_batch_on_mesh(cfg, maxw, ["cpu"] * k, tw, tlen, pw,
                                   plen)
    assert len(shards) == k
    _assert_shards_equal(shards, whole, B)

    rng = random.Random(8)
    content = "".join(rng.choice("ACGT") for _ in range(5000))
    prepared = st.prepare_genome(Genome(content=content))
    starts = torch.tensor([rng.randint(0, 4500) for _ in range(B)],
                          dtype=torch.int64)
    tl = torch.minimum(5000 - starts,
                       torch.tensor(maxw * cfg.tb_limit + cfg.W)).to(
                           torch.int32)
    whole = engine.align_windows(cfg, maxw, prepared.device_words("cpu"),
                                 starts, tl, pw, plen)
    shards = M.align_batch_mapped_on_mesh(cfg, maxw, ["cpu"] * k, prepared,
                                          starts, tl, pw, plen)
    _assert_shards_equal(shards, whole, B)


def test_shard_lanes_stride():
    lanes = M.shard_lanes(10, 3)
    assert [x.tolist() for x in lanes] == [[0, 3, 6, 9], [1, 4, 7],
                                           [2, 5, 8]]
    assert [len(x) for x in M.shard_lanes(2, 4)] == [1, 1, 0, 0]
    assert [len(x) for x in M.shard_lanes(0, 2)] == [0, 0]
    # a tile sorted longest first: every shard gets the same mix
    lens = np.arange(1024)[::-1]
    means = [lens[x].mean() for x in M.shard_lanes(1024, 8)]
    assert max(means) - min(means) <= 7
    with pytest.raises(ValueError):
        M.shard_lanes(4, 0)


def test_resolve_device_indexes_and_refuses():
    assert M.resolve_device("cpu") == M.resolve_device("cpu:0") == \
        M.resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError):
        M.resolve_device("meta")
    assert M.make_mesh(devices=["cpu", "cpu:0"]) == (torch.device("cpu"),) * 2
    assert M.make_mesh(2, devices=["cpu"] * 3) == (torch.device("cpu"),) * 2
    assert M.resolve_mesh(["cpu"] * 3) == (torch.device("cpu"),) * 3
    assert M.resolve_mesh("cpu") == (torch.device("cpu"),)
    for bad in (dict(devices=[]), dict(num_devices=4, devices=["cpu"]),
                dict(num_devices=0, devices=["cpu"])):
        with pytest.raises(ValueError):
            M.make_mesh(**bad)


def test_no_card_no_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: M.make_mesh(), lambda: M.resolve_device("cuda"),
                 lambda: M.resolve_mesh("cuda"),
                 lambda: M.resolve_mesh(["cpu", "cuda:0"]),
                 lambda: st.align_pairs(["ACGT"], ["ACGT"], device="cuda"),
                 lambda: st.align_reads(Genome(content="ACGT"), [],
                                        device=["cuda:0", "cuda:0"])):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


@pytest.fixture
def two_fake_cards(monkeypatch):
    """torch.cuda reporting two cards, the current one cuda:1, and their
    free memory; nothing runs on them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(engine, "free_bytes",
                        lambda d: {0: 8_000, 1: 4_000}[d.index])


def test_cuda_keys_are_indexed(two_fake_cards, monkeypatch):
    """"cuda" means the current card where one device is meant, so it and
    "cuda:1" are one key: the genome is uploaded once for both; "cuda"
    as a mesh is every card."""
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert M.resolve_device("cuda") == M.resolve_device("cuda:1") == cuda1
    assert M.resolve_device(torch.device("cuda")) == cuda1
    with pytest.raises(ValueError, match="2 CUDA devices"):
        M.resolve_device("cuda:2")
    assert M.make_mesh() == (cuda0, cuda1)
    assert M.resolve_mesh("cuda") == M.resolve_mesh(torch.device("cuda")) \
        == (cuda0, cuda1)
    assert M.resolve_mesh("cuda:1") == (cuda1,)
    assert M.resolve_mesh(["cuda", "cuda:1", "cuda:0"]) == (cuda1, cuda1,
                                                           cuda0)

    uploads = []
    monkeypatch.setattr(pack, "to_device",
                        lambda words, dev: uploads.append(dev) or dev)
    prepared = st.prepare_genome(Genome(content="ACGT" * 100))
    for d in ("cuda", "cuda:1", cuda1, torch.device("cuda"), "cuda:0"):
        prepared.device_words(d)
    assert uploads == [cuda1, cuda0]
    assert list(prepared._dev) == [cuda1, cuda0]


def test_scratch_budget_is_split_among_shards_of_a_card(two_fake_cards):
    mesh = M.make_mesh(devices=["cuda:0", "cuda:0", "cuda:1", "cpu",
                                "cuda:0"])
    share = engine.SCRATCH_SHARE
    assert M.scratch_budgets(mesh) == [int(share * 8_000) // 3] * 2 + [
        int(share * 4_000), None, int(share * 8_000) // 3]


def test_run_sharded_order_threads_and_errors():
    seen = {}

    def fn(k, dev):
        seen[k] = threading.get_ident()
        return (k, dev)

    mesh = M.make_mesh(devices=["cpu"] * 4)
    assert M.run_sharded(mesh, fn) == [(k, torch.device("cpu"))
                                       for k in range(4)]
    assert threading.get_ident() not in seen.values()
    # a mesh of one runs on the calling thread, with no executor
    seen.clear()
    with ThreadPoolExecutor(1) as pool:
        assert M.run_sharded(mesh[:1], fn, pool=pool) == [
            (0, torch.device("cpu"))]
    assert seen == {0: threading.get_ident()}

    def fails(k, dev):
        if k == 2:
            raise KeyError("shard 2")
        return k

    with pytest.raises(KeyError, match="shard 2"):
        M.run_sharded(mesh, fails)


def test_stats_add_sums_all_but_num_pairs():
    a = api.AlignStats(num_pairs=10, core_ns=5, retried_pairs=1,
                       readback_bytes=7)
    b = api.AlignStats(num_pairs=3, core_ns=2, retried_pairs=2, prep_ns=4,
                       readback_bytes=1, fail_tb_pairs=1)
    a.add(b)
    assert (a.num_pairs, a.core_ns, a.retried_pairs, a.prep_ns,
            a.readback_bytes, a.fail_tb_pairs) == (10, 7, 3, 4, 8, 1)


def test_launch_counter_is_thread_safe():
    """Shards launch from threads: no launch count may be lost. A stub
    bound in place of the built entry point stands in for the kernel."""
    kern = _cuda.CudaKernel("none.cu", "none", [])
    calls = []
    kern._fn = lambda key, *args: calls.append(key) or 0
    threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda t=t: [kern.launch(t % 3) for _ in range(per)])
            for t in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert len(calls) == threads * per
    assert sum(kern.counts.values()) == threads * per
    assert kern.counts[0] == 6 * per and kern.counts[2] == 5 * per
    kern._fn = lambda key, *args: -1
    with pytest.raises(RuntimeError, match="arguments refused"):
        kern.launch(0)
    assert sum(kern.counts.values()) == threads * per
