"""The port's tile pipeline on the CPU against the JAX package.

align_pairs and align_reads with more than one tile overlap the tiles
(a worker thread finishes tile n while the caller packs and launches
tile n+1) and chunk each tile's upload and readback
(scrooge_tpu_torch/api.py). On ``device="cpu"`` and on the mesh
``["cpu", "cpu"]``, at batch_tile 128 over four tiles and more, strings
and packed, the output must equal the JAX package's ``backend="xla"`` and
the port's own call in one tile (W > 256: test_torch_pipeline_wide.py).
Errors (a non-ACGT read, a location out of bounds, an unalignable pair, a
failing post-process) must be the JAX package's, from the same pair, and
no thread may outlive the call. Inputs come from seeded numpy; every
comparison is exact.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scrooge_tpu  # noqa: E402
import scrooge_tpu.api as jax_api  # noqa: E402
import scrooge_tpu_torch as st  # noqa: E402
from scrooge_tpu import pyref  # noqa: E402
from scrooge_tpu_torch import api  # noqa: E402
from scrooge_tpu_torch.ops import engine  # noqa: E402
from torch_pipeline_cases import (DEVICES, TILE, case,  # noqa: E402
                                  check_tiles, jax_cfg, jax_reads, key,
                                  port_calls, reads)
from torch_threads import one_intra_op_thread  # noqa: E402,F401

# (W, K, O), read lengths: one word on the token path, two words on the
# uint16 runs path (tb_limit 63 > 31)
CONFIGS = {"64-64-33": ((64, 64, 33), 60, 180),
           "128-128-65": ((128, 128, 65), 60, 160)}


@pytest.fixture(scope="module")
def cases():
    return {name: case(*args) for name, args in CONFIGS.items()}


@pytest.mark.parametrize("dev", list(DEVICES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_tiles_equal_jax_and_one_tile(cases, name, dev):
    check_tiles(cases[name], DEVICES[dev])


@pytest.mark.parametrize("name,dev,threads", [("64-64-33", "cpu", 3),
                                              ("64-64-33", "mesh2", 3),
                                              ("128-128-65", "cpu", 3),
                                              ("64-64-33", "cpu", 1)])
def test_small_upload_and_readback_chunks(monkeypatch, cases, name, dev,
                                          threads):
    """Chunk constants set small, so that each tile uploads and reads
    back in several chunks (tokens at 64/64/33, uint16 runs at
    128/128/65), and the strings of a chunk decode in parts on a pool of
    three threads, or in order on one: nothing changes."""
    monkeypatch.setattr(api, "UPLOAD_CHUNK_ROWS", 24)
    monkeypatch.setattr(api, "READBACK_CHUNK_LANES", 16)
    monkeypatch.setattr(api, "DECODE_THREADS", threads)
    monkeypatch.setattr(api, "DECODE_MIN_LANES", 4)
    assert len(api._lane_chunks(TILE)) == api.READBACK_MAX_CHUNKS
    assert len(api._lane_chunks(37)) == 2
    c = cases[name]
    want = {"pairs": c["want_pairs"], "reads": c["want_reads"]}
    for (interface, mode), got in port_calls(c, DEVICES[dev], TILE).items():
        assert got == want[interface], (interface, mode)


def _at_rank(queries, rank):
    """The pair that sorts to ``rank`` (longest read first)."""
    return sorted(range(len(queries)), key=lambda i: -len(queries[i]))[rank]


def _with(seq, pos, char):
    return seq[:pos] + char + seq[pos + 1:]


def _raises_same(port_call, jax_call, port_exc=ValueError,
                 jax_exc=ValueError):
    """Both calls raise, with one message; no thread outlives either.
    Returns the message."""
    before = threading.active_count()
    with pytest.raises(jax_exc) as want:
        jax_call()
    with pytest.raises(port_exc) as got:
        port_call()
    assert threading.active_count() == before
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("dev", list(DEVICES))
def test_non_acgt_in_third_tile_raises_as_jax(cases, dev):
    """Two bad reads in the third tile, lanes 5 and 40 (on a mesh of two,
    in different shards, the later one on shard 0): the first raises; a
    bad text of that tile raises first, as texts are packed first."""
    c = cases["64-64-33"]
    texts, queries = list(c["texts"]), list(c["queries"])
    i, j = _at_rank(queries, 2 * TILE + 5), _at_rank(queries, 2 * TILE + 40)
    queries[i] = _with(queries[i], 10, "N")
    queries[j] = _with(queries[j], 3, "R")
    cfg = st.AlignConfig(batch_tile=TILE)
    jcfg = jax_cfg(64, 64, 33)
    assert "'N'" in _raises_same(
        lambda: st.align_pairs(texts, queries, cfg, device=DEVICES[dev]),
        lambda: scrooge_tpu.align_all(texts, queries, config=jcfg))
    k = _at_rank(queries, 2 * TILE + 60)
    texts[k] = _with(texts[k], 20, "x")
    assert "'x'" in _raises_same(
        lambda: st.align_pairs(texts, queries, cfg, device=DEVICES[dev]),
        lambda: scrooge_tpu.align_all(texts, queries, config=jcfg))
    rs = reads(st.Read, st.CandidateLocation, queries, c["locs"])
    _raises_same(
        lambda: st.align_reads(st.Genome(content=c["genome"]), rs, cfg,
                               device=DEVICES[dev]),
        lambda: jax_reads(c["genome"], queries, c["locs"], 64, 64, 33))


@pytest.mark.parametrize("dev", list(DEVICES))
def test_location_out_of_bounds_in_third_tile_raises_as_jax(cases, dev):
    c = cases["64-64-33"]
    queries, genome = c["queries"], c["genome"]
    locs = [list(ls) for ls in c["locs"]]
    locs[_at_rank(queries, 2 * TILE + 5)][0] = len(genome) + 3
    locs[_at_rank(queries, 2 * TILE + 50)][0] = len(genome) + 9
    msg = _raises_same(
        lambda: st.align_reads(
            st.Genome(content=genome),
            reads(st.Read, st.CandidateLocation, queries, locs),
            st.AlignConfig(batch_tile=TILE), device=DEVICES[dev]),
        lambda: jax_reads(genome, queries, locs, 64, 64, 33))
    assert msg.endswith("out of genome bounds")


@pytest.mark.parametrize("dev", list(DEVICES))
def test_unalignable_pairs_in_two_tiles_raise_as_jax(cases, dev):
    """K = 4 at W = 32: every pair but two is an exact prefix; the two
    unrelated ones sit in tiles two and four, and both packages name the
    one in tile two."""
    c = cases["64-64-33"]
    texts = list(c["texts"])
    queries = [t[: len(q)] for t, q in zip(texts, c["queries"])]
    bad = [_at_rank(queries, r) for r in (TILE + 17, 3 * TILE + 2)]
    for i in bad:
        texts[i], queries[i] = "A" * len(queries[i]), "C" * len(queries[i])
    msg = _raises_same(
        lambda: st.align_pairs(texts, queries,
                               st.AlignConfig(W=32, K=4, O=17,
                                              batch_tile=TILE),
                               device=DEVICES[dev]),
        lambda: scrooge_tpu.align_all(texts, queries,
                                      config=jax_cfg(32, 4, 17)),
        port_exc=st.AlignmentError, jax_exc=jax_api.AlignmentError)
    assert msg.startswith(f"pair {bad[0]}:")


@pytest.mark.parametrize("dev", list(DEVICES))
def test_failing_post_process_raises_as_jax(monkeypatch, cases, dev):
    """The second tile's post-process fails: both packages raise its
    error, and no thread outlives the call."""
    c = cases["64-64-33"]

    def fail_second(real):
        calls = []
        lock = threading.Lock()

        def wrapped(*args, **kwargs):
            with lock:
                calls.append(1)
                nth = len(calls)
            if nth == 2:
                raise RuntimeError("post-process of a tile")
            return real(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(api, "_build_alignments",
                        fail_second(api._build_alignments))
    monkeypatch.setattr(jax_api, "_build_alignments",
                        fail_second(jax_api._build_alignments))
    _raises_same(
        lambda: st.align_pairs(c["texts"], c["queries"],
                               st.AlignConfig(batch_tile=TILE),
                               device=DEVICES[dev]),
        lambda: scrooge_tpu.align_all(c["texts"], c["queries"],
                                      config=jax_cfg(64, 64, 33)),
        port_exc=RuntimeError, jax_exc=RuntimeError)


@pytest.mark.parametrize("dev", list(DEVICES))
@pytest.mark.parametrize("packed", [False, True])
def test_failed_lanes_in_a_middle_tile_are_retried(monkeypatch, cases, dev,
                                                   packed):
    """The engine fails every third lane of its third launch only: those
    pairs go to the scalar oracle and come back exact, in pair order,
    counted in the call's stats."""
    c = cases["64-64-33"]
    real = engine.align_batch
    calls = []
    lock = threading.Lock()

    def failing(*args, **kwargs):
        res = real(*args, **kwargs)
        with lock:
            calls.append(1)
            nth = len(calls)
        if nth == 3:
            res.failed[::3] |= engine.FAIL_INCOMPLETE
        return res

    monkeypatch.setattr(engine, "align_batch", failing)
    cfg = st.AlignConfig(batch_tile=TILE)
    out, stats = st.align_pairs(c["texts"], c["queries"], cfg,
                                return_stats=True, return_packed=packed,
                                device=DEVICES[dev])
    assert key(out.to_alignments() if packed else out) == c["want_pairs"]
    lanes = TILE // (1 if dev == "cpu" else 2)  # a launch's lanes
    assert stats.retried_pairs == stats.fail_incomplete_pairs == len(
        range(0, lanes, 3))
    for i in (0, len(c["texts"]) // 2, len(c["texts"]) - 1):
        assert c["want_pairs"][i] == pyref.align_pair(
            c["texts"][i], c["queries"][i].upper(), cfg)


class _KeepingExecutor(api.ThreadPoolExecutor):
    """A pool that holds on to every task's arguments after the task, as
    a worker thread does until it gets round to dropping its work item."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.kept = []

    def submit(self, fn, *args, **kwargs):
        self.kept.append(args)
        return super().submit(fn, *args, **kwargs)


@pytest.mark.parametrize("packed", [False, True])
def test_finished_tile_results_go_before_the_next_launch(monkeypatch, cases,
                                                         packed):
    """However late the worker drops a finished tile, no launch finds the
    device results of more than one earlier tile alive: the caller lets
    go of a tile's results once the worker has finished it, so a card's
    peak memory does not hang on the worker thread's timing."""
    import weakref

    monkeypatch.setattr(api, "ThreadPoolExecutor", _KeepingExecutor)
    c = cases["64-64-33"]
    real = engine.align_batch
    earlier, alive = [], []

    def counting(*args, **kwargs):
        alive.append(sum(r() is not None for r in earlier))
        res = real(*args, **kwargs)
        earlier.append(weakref.ref(res.entries))
        return res

    monkeypatch.setattr(engine, "align_batch", counting)
    out = st.align_pairs(c["texts"], c["queries"],
                         st.AlignConfig(batch_tile=TILE),
                         return_packed=packed, device="cpu")
    assert key(out.to_alignments() if packed else out) == c["want_pairs"]
    assert alive == [0, 1, 1, 1]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_meta_and_compaction_hold_the_transient_lock(monkeypatch, cases,
                                                     name):
    """A tile's meta and compaction buffers are made under the device's
    transient_lock (tokens at 64/64/33, uint8 runs at 128/128/65), which
    a launch's scratch takes on a card, and the lock is free after the
    call."""
    c = cases[name]
    lock = engine.transient_lock("cpu")
    held = []

    def checked(mod, fn_name):
        real = getattr(mod, fn_name)

        def fn(*args, **kwargs):
            held.append((fn_name, lock.locked()))
            return real(*args, **kwargs)

        monkeypatch.setattr(mod, fn_name, fn)

    from scrooge_tpu_torch.ops import compact, tokens

    for mod, fn_name in ((compact, "batch_meta"),
                         (compact, "compact_entries"),
                         (compact, "compact_entries_u8"),
                         (tokens, "compact_tokenize"),
                         (tokens, "compact_tokens")):
        checked(mod, fn_name)
    W, K, O = c["wko"]
    out = st.align_pairs(c["texts"], c["queries"],
                         st.AlignConfig(W=W, K=K, O=O, batch_tile=TILE),
                         device="cpu")
    assert key(out) == c["want_pairs"]
    names = {n for n, _ in held}
    assert "batch_meta" in names and len(names) >= 2
    assert all(locked for _, locked in held)
    assert not lock.locked()


def test_transient_lock_is_one_a_device():
    assert engine.transient_lock("cpu") is engine.transient_lock(
        torch.device("cpu"))
    assert engine.transient_lock("cuda:0") is not engine.transient_lock(
        "cuda:1")


@pytest.mark.parametrize("wko,route", [((64, 64, 33), "tokens"),
                                       ((128, 128, 65), "uint8"),
                                       ((256, 256, 129), "uint16")])
def test_route_table_maps_configs_to_readback_routes(wko, route):
    """_route maps tb_limit 31 to the tokens, 63 to uint8 runs and 127 to
    uint16 runs; each route's compaction, readback and decoders give one
    hand-made layout's CIGARs and packed runs."""
    from scrooge_tpu_torch.ops import compact, tokens
    from torch_window_harness import layout_with

    W, K, O = wko
    r = api._route(st.AlignConfig(W=W, K=K, O=O))
    assert (r.compact, r.lane_major) == {
        "tokens": (tokens.lane_tokens, True),
        "uint8": (compact.compact_entries_u8, False),
        "uint16": (compact.compact_entries, False)}[route]
    # ops "=XID": lane 0 5=1X3= then 2D4=, lane 1 no runs, lane 2 7D
    entries, counts = layout_with([[[(0, 5), (1, 1), (0, 3)],
                                    [(3, 2), (0, 4)]], [], [[(3, 7)]]])
    res = engine.BatchResult(None, None, torch.from_numpy(entries),
                             torch.from_numpy(counts))
    # edit distance, run total, failure bits, most runs a window, windows
    meta = np.array([[3, 0, 7], [5, 0, 1], [0, 0, 0], [3, 0, 1],
                     [2, 0, 1]], np.int32)
    stats = api.AlignStats()
    got = []
    for packed in (False, True):
        staged, lane_tot, chunks = api._compact(r, res, meta, stats, None,
                                                None)
        got.append(api._read_back(r, staged, lane_tot, chunks, packed,
                                  stats, None, None, None))
    assert got[0] == ["5=1X3=2D4=", "", "7D"]
    flat, offs = got[1]
    assert offs.tolist() == [0, 5, 5, 6]
    assert flat.tolist() == [5, 1 << 12 | 1, 3, 3 << 12 | 2, 4, 3 << 12 | 7]
    assert stats.compact_ns > 0 and stats.format_ns > 0
