"""Host spans and counters of the API's tile pipeline (api.py).

A span times one stage of a call on the host's clock and adds it to a
field of the call's ``AlignStats`` (api.py), as the stages' timers always
have. While a torch profiler is active it also opens a
``torch.profiler.record_function`` range named ``scrooge.<stage>``, so the
stages land in the profiler's chrome trace on the clock of the kernels and
copies, and a device idle gap can be put down to the host stage beneath it
(``profiling/pipeline.py``, ``idle_by_span``). With no profiler active a
span makes no dispatcher call.

record_function's ``args`` string does not reach the chrome trace, so a
range carries its call's id and its tile's index in its name:
``scrooge.pack call=3 tile=1``; ``parse`` takes such a name apart. Every
span of one ``align_reads``/``align_pairs`` call shares its id (``Call``).
Spans nest by time on their own thread only under ``scrooge.call``, which
holds the caller's stages; the worker's follow one another, a chunk's
``scrooge.readback`` and then its ``scrooge.format``.

torch.profiler records the ranges of the thread that started it only,
unless it is asked for every thread (``profile``, as ``pipeline.py``
does): the tile pipeline's worker and a mesh's shard threads open theirs
all the same, and their fields are counted either way.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd.profiler import record_function

PREFIX = "scrooge."
_IDS = itertools.count(1)
_now = time.perf_counter_ns


def label(name: str, call: Optional[int] = None,
          tile: Optional[int] = None) -> str:
    """The profiler range's name of stage ``name`` (see ``parse``)."""
    out = PREFIX + name
    if call is not None:
        out += f" call={call}"
    if tile is not None:
        out += f" tile={tile}"
    return out


def parse(name: str) -> Tuple[str, Optional[int], Optional[int]]:
    """(``scrooge.<stage>``, call id, tile index) of a range's name;
    ids it does not carry are None."""
    stage, *rest = name.split(" ")
    ids = dict(kv.split("=", 1) for kv in rest)
    return (stage, int(ids["call"]) if "call" in ids else None,
            int(ids["tile"]) if "tile" in ids else None)


class span:
    """``with span(name, stats, field, call, tile):`` adds the block's
    host nanoseconds to ``stats.<field>`` (none when ``field`` is None)
    and, only while a profiler is active, records the block as the range
    ``label(name, call.id, tile)``. ``start`` and ``end`` hold its clock
    readings once it has closed."""

    __slots__ = ("stats", "field", "rf", "start", "end")

    def __init__(self, name: str, stats=None, field: Optional[str] = None,
                 call: Optional["Call"] = None, tile: Optional[int] = None):
        self.stats = stats
        self.field = field
        # whether a profiler is active: the flag torch.profiler sets for
        # the process (torch.autograd._profiler_enabled() holds only on the
        # thread that started it, and not at all when every thread is
        # profiled)
        self.rf = (record_function(label(
            name, None if call is None else call.id, tile))
            if _autograd_profiler._is_profiler_enabled else None)

    def __enter__(self) -> "span":
        # the clock reads before the range opens and (below) before it
        # closes: entering and leaving a range lets go of the GIL after
        # its own time stamp, so the wait to take it back falls inside
        # both the range and the span
        self.start = _now()
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = self.end = _now()
        if self.field is not None:
            setattr(self.stats, self.field,
                    getattr(self.stats, self.field) + end - self.start)
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        return False

    @property
    def ns(self) -> int:
        return self.end - self.start


def allocator_count(cards) -> int:
    """Fresh memory the caching allocators have taken so far: device
    segments (``segment.all.allocated``) over ``cards``, plus pinned host
    blocks (``num_host_alloc``) where this torch counts them. 0 with no
    card. The counters are the process's: calls that run at once in one
    process share them."""
    if not cards:
        return 0
    n = sum(torch.cuda.memory_stats(d).get("segment.all.allocated", 0)
            for d in cards)
    host = getattr(torch.cuda, "host_memory_stats", None)
    return n + (host().get("num_host_alloc", 0) if host is not None else 0)


class Call:
    """One public call: the id its spans share, its ``scrooge.call`` range,
    and its edges and allocator misses, added to ``stats`` on a clean exit.

    ``edges_ns`` is the call's head, from entry to the return of its first
    tile's launch (``launched``), plus its tail, from the return of its
    last meta sync (``synced``) to its exit; a call with no tile is all
    edge. ``allocator_misses`` is the change of allocator_count over the
    mesh's cards from ``watch`` to the exit: 0 on the CPU; calls that run
    at once in one process share the counters."""

    def __init__(self, stats):
        self.id, self.stats = next(_IDS), stats
        self.t0 = self.last_sync = None
        self.cards = None
        self._misses0 = 0
        self._lock = threading.Lock()
        self._span = span("call", call=self)

    def __enter__(self) -> "Call":
        self._span.__enter__()
        self.t0 = self.last_sync = self._span.start
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None and self.cards is not None:
            self.stats.edges_ns += _now() - self.last_sync
            self.stats.allocator_misses += (allocator_count(self.cards)
                                            - self._misses0)
        return self._span.__exit__(exc_type, exc, tb)

    def watch(self, mesh) -> None:
        """Start the allocator count on the mesh's cards; the call runs
        the tile pipeline, so its exit adds the tail and the misses."""
        self.cards = list(dict.fromkeys(d for d in mesh if d.type == "cuda"))
        self._misses0 = allocator_count(self.cards)

    def launched(self) -> None:
        """The first tile's launch has returned: the head ends."""
        self.stats.edges_ns += _now() - self.t0

    def synced(self, t: int) -> None:
        """A meta sync returned at ``t`` (any thread)."""
        with self._lock:
            self.last_sync = max(self.last_sync, t)


def profile(cuda: bool):
    """A torch.profiler.profile of the host, and of the cards with
    ``cuda``, that records the ranges of every thread where this torch
    can (``_ExperimentalConfig(profile_all_threads=True)``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        from torch._C._profiler import _ExperimentalConfig

        config = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return _profile(activities=acts)
    return _profile(activities=acts, experimental_config=config)
