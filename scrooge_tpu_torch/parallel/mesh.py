"""Data parallelism over alignment pairs: a batch in shards on several devices.

Port of scrooge_tpu/parallel/mesh.py. Pairs are independent, so the pair
axis is split over a mesh of devices and each shard runs the one-device
engine (ops/engine.py) on its own device; the read-mapping genome is
replicated once on each distinct device, so window reads stay local and
no shard talks to another.

A mesh here is an ordered tuple of indexed torch devices, which may
repeat one: ``["cuda:0", "cuda:0"]`` runs two shards on two streams of
one card, ``["cpu"] * 4`` four shards of the plain engine. Each shard runs
on a host thread of its own with a CUDA stream of its own; the kernel
launch and the native pack and format release the GIL, so the threads
overlap. What the JAX mesh needs for XLA to partition one SPMD program
(``NamedSharding``, ``shard_map``, lane counts in multiples of 128 a
device, the per-mesh compaction) has no counterpart: a shard may hold any
number of lanes, 0 included.
"""

from __future__ import annotations

import collections
import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AlignConfig
from ..ops import engine

Mesh = Tuple[torch.device, ...]


def resolve_device(device) -> torch.device:
    """The one indexed torch.device that ``device`` names; raises rather
    than fall back when CUDA is asked for and absent.

    "cuda" with no index is the current card, ``cuda:{current_device()}``,
    so "cuda" and "cuda:0" give equal keys (a genome replica is kept per
    key); "cpu" and "cpu:0" both give ``torch.device("cpu")``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but "
                           "torch.cuda.is_available() is False")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"device {dev}: this machine has "
                         f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", index)


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The devices of a mesh, in order: ``devices`` (repeats allowed), or
    by default every visible card, cuda:0 .. cuda:{device_count-1}; the
    first ``num_devices`` of them when given. Without a card the default
    raises: it does not fall back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes every visible card and "
                               "torch.cuda.is_available() is False; pass "
                               "devices= for shards on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(resolve_device(d) for d in devices)
    if num_devices is not None:
        if not 1 <= num_devices <= len(mesh):
            raise ValueError(f"requested {num_devices} devices, have "
                             f"{len(mesh)}")
        mesh = mesh[:num_devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def resolve_mesh(device) -> Mesh:
    """The mesh that a public entry point's ``device`` names: "cuda" with
    no index (a string or a torch.device) is every visible card, as the
    JAX package takes every local device; one device is a mesh of one; a
    sequence of devices is a mesh of its entries, repeats included."""
    if isinstance(device, (str, torch.device, int)):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            return make_mesh()
        return (resolve_device(dev),)
    return make_mesh(devices=list(device))


def shard_lanes(n_lanes: int, n_shards: int) -> List[np.ndarray]:
    """The lanes of each shard: lane i goes to shard i mod n_shards.

    A stride rather than contiguous blocks: a tile is sorted by read
    length, longest first, so blocks would give shard 0 all the longest
    reads and make it the one every other shard waits for; a stride gives
    each shard the same mix of lengths. The JAX package shards contiguous
    blocks; the split changes no output. A shard may have any number of
    lanes, 0 included."""
    if n_shards < 1:
        raise ValueError("n_shards must be at least 1")
    return [np.arange(k, n_lanes, n_shards) for k in range(n_shards)]


def scratch_budgets(mesh: Mesh) -> List[Optional[int]]:
    """Per shard, the bytes of R and forefront scratch one launch may take
    (``budget_bytes`` of engine.align_windows): engine.SCRATCH_SHARE of its
    card's free memory divided among the shards that share the card, which
    would otherwise each read the same free memory and each take that
    share of it. None for CPU shards, which take no scratch."""
    sharing = collections.Counter(mesh)
    free = {d: engine.free_bytes(d) for d in sharing if d.type == "cuda"}
    return [int(engine.SCRATCH_SHARE * free[d]) // sharing[d]
            if d.type == "cuda" else None for d in mesh]


def run_sharded(mesh: Mesh, fn: Callable[[int, torch.device], object]
                ) -> list:
    """``fn(k, mesh[k])`` for every shard k, each on a host thread of its
    own with a CUDA stream of its own current (none on the CPU); the
    results in shard order. Each stream first waits for the work already
    queued on its device's current stream (an uploaded genome), and after
    the shards that stream waits for theirs. Raises the first failing
    shard's exception, after every shard has ended."""
    streams = []
    for d in mesh:
        if d.type == "cuda":
            s = torch.cuda.Stream(d)
            s.wait_stream(torch.cuda.current_stream(d))
            streams.append(s)
        else:
            streams.append(None)

    def one(k):
        with (torch.cuda.stream(streams[k]) if streams[k] is not None
              else contextlib.nullcontext()):
            return fn(k, mesh[k])

    with ThreadPoolExecutor(max_workers=len(mesh)) as pool:
        futures = [pool.submit(one, k) for k in range(len(mesh))]
    for d, s in zip(mesh, streams):
        if s is not None:
            torch.cuda.current_stream(d).wait_stream(s)
    return [f.result() for f in futures]


class Shard(NamedTuple):
    lanes: np.ndarray            # the batch lanes of this shard
    result: engine.BatchResult   # on the shard's device


def _record_on_current_stream(res: engine.BatchResult) -> None:
    """The caller uses a shard's outputs on its own stream: tell the
    caching allocator, so their memory is not reused before that work."""
    for t in res:
        if t is not None and t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))


def _on_mesh(mesh, n_lanes: int, shard_fn) -> List[Shard]:
    mesh = resolve_mesh(mesh)
    lanes = shard_lanes(n_lanes, len(mesh))
    budgets = scratch_budgets(mesh)

    def one(k, dev):
        return shard_fn(torch.from_numpy(lanes[k]), dev, budgets[k])

    out = [Shard(lk, res) for lk, res in zip(lanes, run_sharded(mesh, one))]
    for s in out:
        _record_on_current_stream(s.result)
    return out


def align_batch_on_mesh(cfg: AlignConfig, max_windows: int, mesh: Mesh,
                        text_words, text_len, pattern_words,
                        pattern_len) -> List[Shard]:
    """Unstructured pairs on a mesh (any ``device`` that resolve_mesh
    takes): the inputs of engine.align_batch, on the host, split by
    shard_lanes; each shard is uploaded to its device and aligned there on
    its own stream. Returns each shard's lanes and its BatchResult, which
    stays on the shard's device: nothing is gathered across devices."""
    def shard(idx, dev, budget):
        args = [t[idx].to(dev) for t in (text_words, text_len,
                                         pattern_words, pattern_len)]
        return engine.align_batch(cfg, max_windows, *args,
                                  budget_bytes=budget)

    return _on_mesh(mesh, int(pattern_len.shape[0]), shard)


def align_batch_mapped_on_mesh(cfg: AlignConfig, max_windows: int,
                               mesh: Mesh, prepared, starts, text_len,
                               pattern_words, pattern_len) -> List[Shard]:
    """Read mapping on a mesh: the genome of ``prepared`` (an
    api.PreparedGenome) replicated once on each distinct device through
    ``device_words``, the pairs (host tensors: int64 starts, int32 text
    lengths, packed reads and their lengths) split by shard_lanes. Returns
    as align_batch_on_mesh does."""
    mesh = resolve_mesh(mesh)
    words = {d: prepared.device_words(d) for d in dict.fromkeys(mesh)}

    def shard(idx, dev, budget):
        args = [t[idx].to(dev) for t in (starts, text_len, pattern_words,
                                         pattern_len)]
        return engine.align_windows(cfg, max_windows, words[dev], *args,
                                    budget_bytes=budget)

    return _on_mesh(mesh, int(pattern_len.shape[0]), shard)
