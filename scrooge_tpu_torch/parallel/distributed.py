"""Read mapping over several processes with torch.distributed.

Port of scrooge_tpu/parallel/distributed.py. One process per card or per
host: every process holds the whole genome, the (read, candidate) pairs
are dealt round-robin by global pair index, each process aligns its share
on its own device with ``api.align_reads``, and the only collectives are a
failure flag and the optional gather of the results. The gather is of
host objects, as the JAX package's ``process_allgather`` is of host
arrays, so the process group runs on ``gloo``: it needs no NCCL, and one
card can hold several ranks.

Usage, one process per card (``torchrun --nproc_per_node=N script.py``,
or ``srun`` under SLURM; explicit ranks otherwise)::

    from scrooge_tpu_torch.parallel import distributed as dist
    dist.initialize()                 # no-op without a cluster environment
    try:
        alns = dist.align_reads_distributed(genome, reads, cfg)
    finally:
        dist.destroy()
    # with gather=True every process returns the whole list, in pair
    # order; else (its own alignments, their global pair indices)
"""

from __future__ import annotations

import collections
import datetime
import os
import socket
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from .. import api
from ..config import AlignConfig
from ..datamodel import Alignment, Genome, Read
from ..ops import engine
from .mesh import resolve_device

DEFAULT_TIMEOUT_S = 1800.0
_TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "MASTER_ADDR")


def _cluster_env():
    """(init_method, world_size, rank) from the environment a launcher
    sets, or None when there is none: torchrun's WORLD_SIZE, RANK and
    MASTER_ADDR (MASTER_PORT too), else a SLURM job step's SLURM_NTASKS
    and SLURM_PROCID, with MASTER_ADDR or the launching node's address
    and MASTER_PORT (default 29500). A partial torchrun environment
    raises: it names a cluster whose address is missing."""
    env = os.environ
    have = [v for v in _TORCHRUN_VARS if env.get(v)]
    if have:
        missing = [v for v in (*_TORCHRUN_VARS, "MASTER_PORT")
                   if not env.get(v)]
        if missing:
            raise ValueError(f"cluster environment incomplete: {have} set, "
                             f"{missing} missing")
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    if env.get("SLURM_PROCID") and env.get("SLURM_NTASKS"):
        addr = env.get("MASTER_ADDR") or env.get("SLURM_LAUNCH_NODE_IPADDR")
        if not addr:
            raise ValueError("SLURM job step without MASTER_ADDR or "
                             "SLURM_LAUNCH_NODE_IPADDR")
        port = env.get("MASTER_PORT", "29500")
        return (f"tcp://{addr}:{port}", int(env["SLURM_NTASKS"]),
                int(env["SLURM_PROCID"]))
    return None


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Start the gloo process group; a no-op for a plain single-process run.

    Called with no arguments it reads the cluster environment (torchrun
    or SLURM, ``_cluster_env``) and is a no-op only when there is none:
    an argless call on a cluster node must never run single-process,
    where every process would align the whole dataset. Explicit ranks
    take ``init_method`` (e.g. ``"tcp://localhost:29500"``), ``world_size``
    and ``rank``. Every collective waits at most ``timeout_s``."""
    if tdist.is_initialized():
        return
    if init_method is None and world_size is None and rank is None:
        found = _cluster_env()
        if found is None:
            return
        init_method, world_size, rank = found
    if world_size is None or rank is None:
        raise ValueError("initialize needs both world_size and rank")
    tdist.init_process_group(
        "gloo", init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def destroy() -> None:
    """Tear the process group down (a no-op when there is none), so that
    no process hangs at exit."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def process_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def default_device() -> torch.device:
    """``cuda:{LOCAL_RANK mod device_count}``; without LOCAL_RANK (or
    SLURM_LOCALID) the rank stands for it, as on one host. Raises without
    a card: there is no CPU fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError("align_reads_distributed defaults to a card and "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' for the plain engine")
    local = os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID"))
    index = int(local) if local is not None else process_info()[0]
    return torch.device("cuda", index % torch.cuda.device_count())


def shard_reads(reads: Sequence[Read],
                process_id: Optional[int] = None,
                process_count: Optional[int] = None
                ) -> Tuple[List[Read], List[int]]:
    """This process's read shard and the global PAIR indices it owns.

    Pairs (read, candidate) are dealt round-robin by pair index, so the
    load stays balanced when candidate counts vary per read."""
    pid, pcount = process_info()
    if process_id is not None:
        pid = process_id
    if process_count is not None:
        pcount = process_count

    local_reads: List[Read] = []
    local_pair_idx: List[int] = []
    pair_idx = 0
    for read in reads:
        kept = [(pair_idx + i, loc)
                for i, loc in enumerate(read.locations)
                if (pair_idx + i) % pcount == pid]
        if kept:
            local_reads.append(Read(description=read.description,
                                    content=read.content,
                                    locations=[loc for _, loc in kept]))
            local_pair_idx.extend(gi for gi, _ in kept)
        pair_idx += len(read.locations)
    return local_reads, local_pair_idx


def scratch_budget(device) -> Optional[int]:
    """Bytes of scratch one launch of this rank may take on its card:
    engine.SCRATCH_SHARE of the card's free memory divided among the ranks
    on this host that share the card (a collective: every rank calls it).
    None on the CPU."""
    dev = resolve_device(device)
    key = (socket.gethostname(), str(dev))
    _, world = process_info()
    keys = [key]
    if world > 1:
        keys = [None] * world
        tdist.all_gather_object(keys, key)
    if dev.type != "cuda":
        return None
    sharing = collections.Counter(keys)[key]
    return int(engine.SCRATCH_SHARE * engine.free_bytes(dev)) // sharing


def _check_peers(error: Optional[BaseException]) -> None:
    """Every rank says whether its shard aligned; if one did not, every
    rank raises (the failing one its own error), so none is left waiting
    in the result gather."""
    _, world = process_info()
    if world == 1:
        if error is not None:
            raise error
        return
    mine = None if error is None else (type(error).__name__, str(error))
    states = [None] * world
    tdist.all_gather_object(states, mine)
    if error is not None:
        raise error
    failed = [(r, s) for r, s in enumerate(states) if s is not None]
    if failed:
        r, (kind, msg) = failed[0]
        cls = api.AlignmentError if kind == "AlignmentError" else RuntimeError
        raise cls(f"rank {r} failed to align its shard: {kind}: {msg}")


def gather_alignments(local_alns: Sequence[Alignment],
                      local_idx: Sequence[int],
                      total: int) -> List[Optional[Alignment]]:
    """Every rank's alignments and their pair indices, gathered to every
    rank and placed in a list of ``total`` in pair order (a collective:
    every rank calls it).

    ``all_gather_object``: each rank's (indices, alignments) pickled, in
    place of the JAX package's gather of arrays padded to a common shape
    (scrooge_tpu/parallel/distributed.py:151-190). On the bench tile over
    two processes on an H100 the padded gather was no faster (PERF.md,
    the multi-device findings), and this is a third of the code. Only
    this program's ranks send what is unpickled."""
    _, world = process_info()
    parts = [(list(local_idx), list(local_alns))]
    if world > 1:
        parts = [None] * world
        tdist.all_gather_object(parts, (list(local_idx), list(local_alns)))
    out: List[Optional[Alignment]] = [None] * total
    for idx, alns in parts:
        for i, a in zip(idx, alns):
            out[i] = a
    return out


def align_reads_distributed(genome: Genome, reads: Sequence[Read],
                            config: Optional[AlignConfig] = None,
                            gather: bool = True, *, device=None):
    """Read mapping across every process; each aligns its pair shard
    (shard_reads) on ``device`` (default: default_device()), with its
    part of the card's scratch when ranks share one (scratch_budget).

    With gather=True every process returns the whole alignment list in
    pair order; otherwise ``(local_alignments, global_pair_indices)``. A
    shard that raises makes every rank raise, after a gather of failure
    flags that comes before any result gather."""
    cfg = config or AlignConfig()
    local_reads, local_idx = shard_reads(reads)
    dev = default_device() if device is None else resolve_device(device)
    budget = scratch_budget(dev)
    error = None
    local_alns: List[Alignment] = []
    try:
        local_alns = api.align_reads(genome, local_reads, cfg, device=dev,
                                     budget_bytes=budget)
    except Exception as e:  # every rank must learn of it: see _check_peers
        error = e
    _check_peers(error)
    if not gather:
        return local_alns, local_idx
    return gather_alignments(local_alns, local_idx,
                             sum(len(r.locations) for r in reads))
