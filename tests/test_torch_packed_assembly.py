"""The port's packed assembly into pair order, on the CPU.

``api._assemble_packed_parts`` merges the tiles' lane-order packed runs
and the retried pairs' CIGARs into one pair-order PackedAlignments, as the
JAX package's does (scrooge_tpu/api.py:658-738): one concatenation when
nothing was retried and the lanes are the pairs in order, else a length
scatter and the native permutation copy ``native.scatter_runs``. On parts
made from seeded numpy (identity order in one and in two tiles, permuted
tiles, strided mesh shards, failed lanes with retries, failed lanes in
identity order, longer offset arrays) it must equal the JAX package's
function and the per-pair loop it replaced, kept here as the plain
version, array for array; and ``align_pairs`` must take the identity path
for reads of one length and the scatter for reads of many.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scrooge_tpu.api as jax_api  # noqa: E402
from scrooge_tpu import native as jax_native  # noqa: E402
from scrooge_tpu.datamodel import Alignment as JaxAlignment  # noqa: E402
import scrooge_tpu_torch as st  # noqa: E402
from scrooge_tpu_torch import api, native  # noqa: E402
from scrooge_tpu_torch.datamodel import Alignment, PackedAlignments  # noqa: E402
from scrooge_tpu_torch.parallel.mesh import shard_lanes  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

OPS = "=XID"


def plain_assemble(n, parts, results):
    """The per-pair copy loop that _assemble_packed_parts replaced."""
    eds_out = np.zeros(n, np.int32)
    lens = np.zeros(n, np.int64)
    retry_runs = {}
    for i, r in enumerate(results):
        if isinstance(r, Alignment):
            retry_runs[i] = api._runs_from_cigar(r.cigar)
            lens[i] = len(retry_runs[i])
            eds_out[i] = r.edit_distance
    sel = []
    for flat, offs, idxs, eds, failed in parts:
        k = len(idxs)
        ok = np.asarray(failed[:k]) == 0
        dst = np.asarray(idxs, np.int64)[ok]
        src = offs[:k][ok]
        src_lens = (offs[1 : k + 1] - offs[:k])[ok]
        lens[dst] = src_lens
        eds_out[dst] = np.asarray(eds[:k])[ok]
        sel.append((flat, src, dst, src_lens))
    out_offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=out_offs[1:])
    out = np.empty(int(out_offs[-1]), np.uint16)
    for flat, src, dst, src_lens in sel:
        for o, i, ln in zip(src.tolist(), out_offs[dst].tolist(),
                            src_lens.tolist()):
            out[i : i + ln] = flat[o : o + ln]
    for i, runs in retry_runs.items():
        out[out_offs[i] : out_offs[i] + len(runs)] = runs
    return PackedAlignments(eds_out, out_offs, out)


def _pair_runs(rng, n):
    """Each pair's uint16 runs (0 to 40; a few of 4095) and distance."""
    runs = []
    for _ in range(n):
        k = int(rng.integers(0, 41))
        ops = rng.integers(0, 4, k)
        cnt = np.where(rng.random(k) < 0.05, 4095, rng.integers(1, 64, k))
        runs.append(((ops << 12) | cnt).astype(np.uint16))
    return runs, rng.integers(0, 90, n).astype(np.int32)


def make_parts(seed, n, tile, permuted, fail_every=0, shards=1,
               extra_offs=0):
    """(parts, port results, JAX results): the pairs in tiles of ``tile``
    in pair order or a seeded permutation, each tile's lanes split over
    ``shards`` strided shards (a part each); every ``fail_every``-th lane
    failed, its flat holding garbage runs, its pair retried with a CIGAR
    whose runs go past 4095. ``extra_offs`` lengthens each part's
    offsets past its lanes."""
    rng = np.random.default_rng(seed)
    runs, eds = _pair_runs(rng, n)
    order = rng.permutation(n) if permuted else np.arange(n)
    parts, results, jresults = [], [None] * n, [None] * n
    lane = 0
    for t0 in range(0, n, tile):
        tile_pairs = order[t0 : t0 + tile]
        for lanes in shard_lanes(len(tile_pairs), shards):
            idxs = [int(i) for i in tile_pairs[lanes]]
            k = len(idxs)
            if k == 0:
                continue
            failed = np.zeros(k, np.int32)
            lane_runs = []
            for j, i in enumerate(idxs):
                if fail_every and (lane + j) % fail_every == 3:
                    failed[j] = 1
                    lane_runs.append(rng.integers(0, 1 << 16, int(
                        rng.integers(0, 9))).astype(np.uint16))
                    cigar = f"{5000 + i}=2X{i % 7 + 1}I"
                    results[i] = Alignment(cigar=cigar, edit_distance=i)
                    jresults[i] = JaxAlignment(cigar=cigar, edit_distance=i)
                else:
                    lane_runs.append(runs[i])
            lane += k
            offs = np.zeros(k + 1 + extra_offs, np.int64)
            np.cumsum([len(r) for r in lane_runs], out=offs[1 : k + 1])
            offs[k + 1 :] = offs[k]
            flat = (np.concatenate(lane_runs) if lane_runs
                    else np.zeros(0, np.uint16))
            lane_eds = np.where(failed != 0, -1, eds[idxs]).astype(np.int32)
            parts.append((flat, offs, idxs, lane_eds, failed))
    return parts, results, jresults


CASES = {
    "identity-one-tile": dict(n=300, tile=512, permuted=False),
    "identity-two-tiles": dict(n=300, tile=150, permuted=False),
    "identity-three-tiles": dict(n=300, tile=128, permuted=False),
    "permuted": dict(n=300, tile=128, permuted=True),
    "permuted-mesh": dict(n=300, tile=128, permuted=True, shards=3),
    "identity-mesh": dict(n=300, tile=128, permuted=False, shards=2),
    "retried": dict(n=300, tile=128, permuted=True, fail_every=11),
    "failed-identity": dict(n=300, tile=150, permuted=False, fail_every=17),
    "long-offsets": dict(n=300, tile=150, permuted=False, extra_offs=2),
}
# the cases the JAX package stitches without its scatter (api.py:680-717)
IDENTITY = {"identity-one-tile", "identity-two-tiles",
            "identity-three-tiles"}


def _arrays(p):
    return p.edit_distances, p.run_offsets, p.runs


@pytest.mark.parametrize("name", list(CASES))
def test_assembly_equals_jax_and_plain(monkeypatch, name):
    parts, results, jresults = make_parts(7, **CASES[name])
    n = CASES[name]["n"]
    calls = []
    scatter = native.scatter_runs

    def counted(*args):
        calls.append(len(args[2]))
        return scatter(*args)

    monkeypatch.setattr(native, "scatter_runs", counted)
    got = api._assemble_packed_parts(n, parts, results)
    want = jax_api._assemble_packed_parts(n, parts, jresults)
    plain = plain_assemble(n, parts, results)
    for g, w, p in zip(_arrays(got), _arrays(want), _arrays(plain)):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, p)
    assert (got.edit_distances.dtype, got.run_offsets.dtype,
            got.runs.dtype) == (np.int32, np.int64, np.uint16)
    assert len(got) == n and got.run_offsets[-1] == len(got.runs)
    # identity parts never reach the scatter; the rest scatter each part
    # once, the failed lanes left out
    assert calls == ([] if name in IDENTITY
                     else [int((np.asarray(f) == 0).sum())
                           for _, _, _, _, f in parts])
    if CASES[name].get("fail_every"):
        assert sum(r is not None for r in results) > 0
        i = next(i for i, r in enumerate(results) if r is not None)
        assert got.cigar(i) == results[i].cigar.replace(
            f"{5000 + i}=", f"4095={5000 + i - 4095}=")


def test_one_identity_tile_is_returned_without_a_copy():
    parts, results, _ = make_parts(3, n=200, tile=256, permuted=False)
    got = api._assemble_packed_parts(200, parts, results)
    assert got.run_offsets is parts[0][1]
    assert np.shares_memory(got.runs, parts[0][0])


def test_scatter_runs_equals_jax():
    rng = np.random.default_rng(5)
    n = 500
    lens = rng.integers(0, 30, n).astype(np.int64)
    offs = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    flat = rng.integers(0, 1 << 16, int(lens.sum())).astype(np.uint16)
    idx = rng.permutation(n + 20)[:n].astype(np.int64)
    dst_lens = np.zeros(n + 20, np.int64)
    dst_lens[idx] = lens
    out_offs = np.zeros(n + 21, np.int64)
    np.cumsum(dst_lens, out=out_offs[1:])
    got = np.full(int(out_offs[-1]), 7, np.uint16)
    want = got.copy()
    assert native.scatter_runs(flat, offs, idx, lens, got, out_offs) is None
    assert jax_native.scatter_runs(flat, offs, idx, lens, want, out_offs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("equal_lengths", [True, False])
def test_align_pairs_takes_the_identity_path_for_one_length(monkeypatch,
                                                            equal_lengths):
    """Two tiles of 128 at 64/64/33: reads of one length keep the length
    sort's order and are stitched; reads of many lengths are permuted and
    scattered, one call a tile. Either way packed equals strings."""
    rng = np.random.default_rng(11)
    codes = np.frombuffer(b"ACGT", np.uint8)
    n = 200
    texts = [codes[rng.integers(0, 4, 160)].tobytes().decode()
             for _ in range(n)]
    lens = (np.full(n, 120) if equal_lengths
            else rng.integers(60, 150, n))
    queries = [t[:ln] for t, ln in zip(texts, lens)]
    queries = [q[:5] + "A" + q[6:] for q in queries]
    calls = []
    scatter = native.scatter_runs
    monkeypatch.setattr(native, "scatter_runs",
                        lambda *a: calls.append(1) or scatter(*a))
    cfg = st.AlignConfig(batch_tile=128)
    packed = st.align_pairs(texts, queries, cfg, return_packed=True,
                            device="cpu")
    strs = st.align_pairs(texts, queries, cfg, device="cpu")
    assert packed.to_alignments() == strs
    assert calls == ([] if equal_lengths else [1, 1])
