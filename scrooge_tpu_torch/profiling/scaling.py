"""Scaling of the port over cards, shards and processes.

Port of scrooge_tpu/profiling/scaling.py, without its ``--engine``
choice: the port picks its kernel from W (W=64 here, genasm_windows1 on
a card, the plain engine on the CPU; the ``engine`` column says which
ran). Three measurements, each a CSV:

- ``measure`` (default): aligns/s at a fixed per-device batch on meshes
  of 1, 2, 4, .. N shards (parallel/mesh.py, engine level), and the
  weak-scaling efficiency aps_N / (N aps_1). Shard k runs on card
  k mod device_count, so N above the card count puts several shards on
  one card; ``--device cpu`` runs every shard on the CPU.
- ``--device_time``: the time each mesh spends in the engine, summed
  over shards: on a card each shard's kernel time alone, with CUDA events
  on its device (profiling/kernel_time.engine_ms); on the CPU the
  process CPU time of the whole mesh, as the JAX harness measures.
  ``work_ratio`` is device_N / (N device_1): ~1.0 when sharding adds no
  per-device work (recompute, copies), >1 when it does.
- ``--distributed N``: real 1- and N-process runs on this machine
  (parallel/distributed.py, gloo), each process aligning its round-robin
  pair share through ``api.align_reads``; rank k takes card
  k mod device_count. ``cpu_normalized_efficiency`` is the JAX harness's:
  CPU seconds a pair at 1 process over those at N.

Every row says what it ran on: ``card`` (the card's name as
torch.cuda.get_device_name gives it, which is nvidia-smi's, or ``cpu``),
``cards`` (the distinct devices used) and ``shards`` or ``processes``;
``devices`` is the JAX column, the shards of the mesh. Two shards or two
processes on one card read as exactly that, so no row can pass for
scaling over cards. A row reports what was measured and asserts no
efficiency.

Usage:
  python -m scrooge_tpu_torch.profiling.scaling --out scaling.csv \\
      [--device cuda|cpu] [--shards N] [--per_device 1024] [--read_len 600]
  python -m scrooge_tpu_torch.profiling.scaling --device_time --out dt.csv
  python -m scrooge_tpu_torch.profiling.scaling --distributed 2 --out d.csv

On a cluster, start the worker on every host instead of --distributed:
  python -m scrooge_tpu_torch.profiling.scaling --dist_worker \\
      $RANK:$WORLD:$PORT --coordinator $ADDR --per_process 32768
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import AlignConfig
from ..ops import _cuda, engine, pack
from ..parallel import mesh as M

CFG = AlignConfig(W=64, K=64, O=33)
# what one process of --distributed takes on a card besides its scratch
# (its CUDA context, torch's allocator, the genome): a harness that would
# put more processes on a card than fit is refused before it starts
PROCESS_BYTES = 2 << 30
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _meshes(device: str, shards):
    """Meshes of 1, 2, 4, .. up to ``shards`` entries (and ``shards``
    itself): shard k on card k mod device_count, or all on the CPU."""
    if device == "cuda":
        count = len(M.make_mesh())  # raises without a card
        top = shards or count
    else:
        count, top = 1, shards or 2
    sizes, n = [], 1
    while n < top:
        sizes.append(n)
        n *= 2
    sizes.append(top)
    return [M.make_mesh(devices=[f"cuda:{k % count}" if device == "cuda"
                                 else "cpu" for k in range(n)])
            for n in sizes]


def _card(devs) -> str:
    names = dict.fromkeys(torch.cuda.get_device_name(d) if d.type == "cuda"
                          else "cpu" for d in devs)
    return "+".join(names)


def _describe(mesh) -> dict:
    return {"card": _card(mesh), "cards": len(set(mesh)),
            "shards": len(mesh)}


def _engine_name(device: str) -> str:
    return (os.path.splitext(engine.window_kernel(CFG).source)[0]
            if device == "cuda" else "plain")


def _batch(B: int, read_len: int, seed: int = 5):
    """B random texts of read_len + 80 chars and reads of read_len with 5 %
    substitutions (the JAX harness's batch), packed, on the host."""
    rng = np.random.default_rng(seed)
    tl = read_len + 80
    text = rng.integers(0, 4, (B, tl), dtype=np.uint8)
    pattern = np.where(rng.random((B, read_len)) < 0.05,
                       rng.integers(0, 4, (B, read_len), dtype=np.uint8),
                       text[:, :read_len]).astype(np.uint8)
    return (pack.pack_2bit(torch.from_numpy(text)),
            torch.full((B,), tl, dtype=torch.int32),
            pack.pack_2bit(torch.from_numpy(pattern)),
            torch.full((B,), read_len, dtype=torch.int32))


def _launches() -> int:
    return sum(sum(k.counts.values()) for k in _cuda.KERNELS)


def _check_ran(device: str, before: int) -> None:
    if device == "cuda" and _launches() == before:
        raise RuntimeError("the window kernel never launched")


def _time_mesh(device: str, mesh, B: int, read_len: int, reps: int):
    """(the host batch, wall s, process CPU s) of one align_batch_on_mesh
    call, host to host (upload, engine, the distances read back), the
    mean of ``reps`` calls after a warm-up call that builds the kernel."""
    maxw = CFG.max_windows(read_len)
    batch = _batch(B, read_len)

    def run():
        for s in M.align_batch_on_mesh(CFG, maxw, mesh, *batch):
            s.result.edit_distance.cpu()

    run()
    before = _launches()
    c0 = time.process_time()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    wall = (time.perf_counter() - t0) / reps
    cpu = (time.process_time() - c0) / reps
    _check_ran(device, before)
    return batch, wall, cpu


def measure(device: str, shards, per_device: int, read_len: int,
            reps: int):
    """aligns/s of align_batch_on_mesh at ``per_device`` pairs a shard
    (_time_mesh) on each mesh of _meshes."""
    rows, base_aps = [], None
    for mesh in _meshes(device, shards):
        n = len(mesh)
        B = per_device * n
        _, wall, _ = _time_mesh(device, mesh, B, read_len, reps)
        aps = B / wall
        base_aps = base_aps or aps
        eff = aps / (base_aps * n)
        rows.append({"platform": device, "engine": _engine_name(device),
                     "devices": n, "batch": B, "read_len": read_len,
                     "aligns_per_second": aps,
                     "weak_scaling_efficiency": eff, **_describe(mesh)})
        print(f"shards={n} cards={rows[-1]['cards']} batch={B} "
              f"{aps:,.0f} aligns/s eff={eff:.2%}", file=sys.stderr)
    return rows


def measure_device_time(device: str, shards, per_device: int,
                        read_len: int, reps: int):
    """Engine time of each mesh, summed over its shards (see the module
    docstring), and the wall time of one mesh call."""
    from . import kernel_time

    maxw = CFG.max_windows(read_len)
    rows, base = [], None
    for mesh in _meshes(device, shards):
        n = len(mesh)
        B = per_device * n
        batch, wall, cpu = _time_mesh(device, mesh, B, read_len, reps)
        if device == "cuda":
            spent = 0.0
            for lanes, dev in zip(M.shard_lanes(B, n), mesh):
                idx = torch.from_numpy(lanes)
                tw, tlen, pw, plen = (t[idx].to(dev) for t in batch)
                base_chars = torch.arange(len(lanes), dtype=torch.int64,
                                          device=dev) * (tw.shape[1] * 16)
                staged = (CFG, maxw, (tw, base_chars, tlen, pw, plen),
                          len(lanes))
                spent += min(kernel_time.engine_ms(staged, reps, 1)) / 1e3
            timer = "cuda_events"
        else:
            spent, timer = cpu, "process_time"
        base = base or spent
        ratio = spent / (base * n)
        rows.append({"platform": device, "engine": _engine_name(device),
                     "devices": n, "batch": B, "read_len": read_len,
                     "device_s": spent, "wall_s": wall,
                     "per_device_s": spent / n, "work_ratio": ratio,
                     "timer": timer, **_describe(mesh)})
        print(f"shards={n} batch={B} device={spent:.4f}s "
              f"per-device={spent / n:.4f}s work_ratio={ratio:.3f}",
              file=sys.stderr)
    return rows


def _dist_worker(pid: int, nproc: int, port: str, coordinator: str,
                 per_process: int, read_len: int, device: str) -> int:
    """One process of the --distributed harness: aligns its round-robin
    pair share of a deterministic dataset through api.align_reads between
    two barriers; rank 0 prints one JSON row."""
    import torch.distributed as tdist

    from .. import api
    from ..parallel import distributed as dist
    from ..utils.simulate import simulate_dataset

    dist.initialize(init_method=f"tcp://{coordinator}:{port}",
                    world_size=nproc, rank=pid, timeout_s=600)
    try:
        if device == "cuda":
            dev = dist.default_device()
        else:
            # the processes share this host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // nproc))
            dev = torch.device("cpu")
        total_pairs = per_process * nproc
        ds = simulate_dataset(genome_len=200_000, num_reads=total_pairs,
                              read_len=read_len, accuracy=0.95, seed=23)
        cfg = AlignConfig(W=64, K=64, O=33,
                          batch_tile=max(128, min(per_process, 2048)))
        budget = dist.scratch_budget(dev)
        local_reads, _ = dist.shard_reads(ds.reads)
        # builds the kernel outside the timed window
        api.align_reads(ds.genome, local_reads[: cfg.batch_tile], cfg,
                        device=dev, budget_bytes=budget)
        tdist.barrier()
        c0 = time.process_time()
        t0 = time.perf_counter()
        api.align_reads(ds.genome, local_reads, cfg, device=dev,
                        budget_bytes=budget)
        local_dt = time.perf_counter() - t0
        # CPU seconds of the aligned work itself, before the end barrier:
        # processes that timeshare one host's cores bound the wall
        # efficiency by 1/N, and CPU seconds a pair is what a run on N
        # hosts keeps (the JAX harness's normalization)
        local_cpu = time.process_time() - c0
        tdist.barrier()
        wall = time.perf_counter() - t0
        mine = (local_dt, local_cpu, socket.gethostname(), str(dev),
                _card([dev]))
        gathered = [None] * nproc
        tdist.all_gather_object(gathered, mine)
        if pid == 0:
            dts = [g[0] for g in gathered]
            cpus = [g[1] for g in gathered]
            print(json.dumps({
                "platform": device, "processes": nproc,
                "per_process": per_process, "total_pairs": total_pairs,
                "read_len": read_len,
                "aligns_per_second": total_pairs / wall,
                "slowest_process_s": max(dts), "cpu_s": sum(cpus),
                "cpu_s_max": max(cpus),
                "card": "+".join(dict.fromkeys(g[4] for g in gathered)),
                "cards": len({(g[2], g[3]) for g in gathered})}))
    finally:
        dist.destroy()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check_capacity(device: str, nproc: int) -> None:
    """Refuse a run whose processes would not fit their cards."""
    if device != "cuda":
        return
    cards = M.make_mesh()  # raises without a card
    per_card = math.ceil(nproc / len(cards))
    for d in cards[: min(nproc, len(cards))]:
        free, _ = torch.cuda.mem_get_info(d)
        if per_card * PROCESS_BYTES > free:
            raise ValueError(
                f"{nproc} processes put {per_card} on {d}, which has "
                f"{free / 2**30:.1f} GiB free: each needs about "
                f"{PROCESS_BYTES / 2**30:.0f} GiB")


def run_distributed(nproc_max: int, per_process: int, read_len: int,
                    device: str, timeout_s: float):
    """Rows of 1- and ``nproc_max``-process runs of _dist_worker on this
    machine. A worker that fails or outlives ``timeout_s`` fails the run:
    every worker is then stopped and RuntimeError raised."""
    _check_capacity(device, nproc_max)
    env = dict(os.environ, PYTHONPATH=_PKG_PARENT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    rows, base_aps, base_cpu_per_pair = [], None, None
    for n in sorted({1, nproc_max}):
        port = _free_port()
        with tempfile.TemporaryDirectory(prefix="scrooge_scaling_") as tmp:
            logs = [open(os.path.join(tmp, f"rank{p}.{k}"), "w+")
                    for p in range(n) for k in ("out", "err")]
            procs = [subprocess.Popen(
                [sys.executable, "-m", "scrooge_tpu_torch.profiling.scaling",
                 "--dist_worker", f"{p}:{n}:{port}",
                 "--per_process", str(per_process),
                 "--read_len", str(read_len), "--device", device],
                env=env, stdout=logs[2 * p], stderr=logs[2 * p + 1])
                for p in range(n)]
            try:
                deadline = time.monotonic() + timeout_s
                for pr in procs:
                    pr.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"distributed run at n={n} outlived "
                                   f"{timeout_s} s") from None
            finally:
                for pr in procs:
                    if pr.poll() is None:
                        pr.kill()
                        pr.wait()
                texts = []
                for f in logs:
                    f.seek(0)
                    texts.append(f.read())
                    f.close()
            if any(pr.returncode for pr in procs):
                raise RuntimeError(f"distributed run at n={n} failed:\n"
                                   + "\n".join(t[-2000:] for t in texts[1::2]))
        row = json.loads(texts[0].strip().splitlines()[-1])
        aps = row["aligns_per_second"]
        cpu_per_pair = row["cpu_s"] / row["total_pairs"]
        base_aps = base_aps or aps
        base_cpu_per_pair = base_cpu_per_pair or cpu_per_pair
        row["weak_scaling_efficiency"] = aps / (base_aps * n)
        row["cpu_normalized_efficiency"] = base_cpu_per_pair / cpu_per_pair
        print(f"processes={n} cards={row['cards']} {aps:,.0f} aligns/s "
              f"eff={row['weak_scaling_efficiency']:.2%} "
              f"cpu_eff={row['cpu_normalized_efficiency']:.2%}",
              file=sys.stderr)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the shards run (no fallback)")
    p.add_argument("--shards", type=int, default=None,
                   help="largest mesh (default: every card; 2 on the cpu)")
    p.add_argument("--per_device", type=int, default=1024)
    p.add_argument("--read_len", type=int, default=600)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", help="the CSV to write (required)")
    p.add_argument("--distributed", type=int, default=0, metavar="N",
                   help="real 1- and N-process runs on this machine")
    p.add_argument("--device_time", action="store_true",
                   help="engine time summed over shards, and work_ratio")
    p.add_argument("--per_process", type=int, default=2048)
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds a --distributed run may take")
    p.add_argument("--dist_worker", default=None, metavar="PID:NPROC:PORT",
                   help="run as one process of a distributed run")
    p.add_argument("--coordinator", default="127.0.0.1",
                   help="rank 0's address, for --dist_worker")
    args = p.parse_args(argv)
    if args.dist_worker:
        pid, nproc, port = args.dist_worker.split(":")
        return _dist_worker(int(pid), int(nproc), port, args.coordinator,
                            args.per_process, args.read_len, args.device)
    if not args.out:
        p.error("--out is required")
    if args.distributed:
        rows = run_distributed(args.distributed, args.per_process,
                               args.read_len, args.device, args.timeout)
    elif args.device_time:
        rows = measure_device_time(args.device, args.shards,
                                   args.per_device, args.read_len, args.reps)
    else:
        rows = measure(args.device, args.shards, args.per_device,
                       args.read_len, args.reps)
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[-1].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
