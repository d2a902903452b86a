"""End-to-end stage breakdown of align_reads, one row per call and mode.

The port of the breakdown that the JAX package's bench.py writes to
profile/pipeline_breakdown.csv (bench.py:256-291), the input of
``profiling.plots pipeline``. One simulated dataset (by default the bench
workload: ``simulate_dataset`` of a 1 Mbp genome and 16,384 reads of
10 kbp at 95 % accuracy, seed 7) goes through the public ``align_reads``
on ``--device`` at ``--batch_tile``, strings then packed, after one
warm-up call. Each row holds the call's wall clock and its AlignStats
stages (with more than one tile they overlap, so they may sum to more than
the wall), the link rates they imply (bytes over the copies' time), and
what ran: ``engine``, ``card``, ``tiles``. ``--trace`` adds a second,
traced call a mode, whose torch.profiler trace gives the device's busy
share of the call.

The file imports the package by its absolute name, so it also runs as a
script against another checkout of the package, to time a change against
its parent in turns:

    cd <parent checkout> && PYTHONPATH=. python <this file> --out p.csv

Usage:
  python -m scrooge_tpu_torch.profiling.pipeline --out pipeline.csv \\
      [--device cuda] [--reads 16384] [--read_len 10000] \\
      [--batch_tile 1024] [--W 64 --K 64 --O 33] [--reps 1] [--trace] \\
      [--no_warmup] [--decode_threads N]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import tempfile
import time

import torch

import scrooge_tpu_torch as st
from scrooge_tpu_torch.ops import engine
from scrooge_tpu_torch.utils.simulate import simulate_dataset

HEADER = ["mode", "wall_s", "prep_s", "upload_s", "upload_mb", "core_s",
          "compact_s", "readback_s", "readback_mb", "format_s", "pairs",
          "read_len", "h2d_mb_s", "d2h_mb_s",
          # what ran, beside the JAX columns
          "W", "batch_tile", "tiles", "engine", "card", "device_busy_share"]


def _first(device) -> torch.device:
    """The device, or a mesh's first."""
    return torch.device(device if isinstance(device, (str, torch.device))
                        else device[0])


def _sync(device) -> None:
    if _first(device).type == "cuda":
        torch.cuda.synchronize(_first(device))


def call(prepared, reads, cfg, device, packed: bool):
    """(output, AlignStats, wall seconds) of one align_reads call, host to
    host: the device is idle before it and the output is on the host."""
    _sync(device)
    t0 = time.perf_counter()
    out, stats = st.align_reads(prepared, reads, cfg, return_stats=True,
                                return_packed=packed, device=device)
    return out, stats, time.perf_counter() - t0


def trace_shares(path: str, kernel: str = "genasm_windows"):
    """From a torch.profiler chrome trace: (launches of kernels whose name
    holds ``kernel``, their ms, the device's busy share, the annotated
    call's ms) over the ``align_reads`` annotation. Busy is the union of
    kernel, copy and set intervals on the device, on every stream, within
    the call; idle is the rest."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = next(e for e in events if e.get("name") == "align_reads"
                and e.get("cat") == "user_annotation")
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    on_dev = sorted((max(float(e["ts"]), t0),
                     min(float(e["ts"]) + float(e["dur"]), t1))
                    for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                    and "dur" in e)
    busy, end = 0.0, t0
    for a, b in on_dev:
        a = max(a, end)
        if b > a:
            busy, end = busy + b - a, b
    window = [e for e in events if e.get("cat") == "kernel"
              and kernel in e.get("name", "")]
    return (len(window), sum(float(e["dur"]) for e in window) / 1e3,
            busy / (t1 - t0), (t1 - t0) / 1e3)


def traced_call(prepared, reads, cfg, device, packed: bool, path: str):
    """call() under torch.profiler (host and device activity), the call
    annotated ``align_reads``; the trace is written to ``path``. Returns
    call()'s result and trace_shares(path)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("align_reads"):
            result = call(prepared, reads, cfg, device, packed)
            _sync(device)
    prof.export_chrome_trace(path)
    return result, trace_shares(path)


def row(mode: str, stats, wall: float, reads, cfg, device,
        busy=None) -> dict:
    """A CSV row (HEADER) of one call."""
    s = 1e-9
    dev = _first(device)
    return {
        "mode": mode, "wall_s": wall, "prep_s": stats.prep_ns * s,
        "upload_s": stats.upload_ns * s,
        "upload_mb": stats.upload_bytes / 1e6, "core_s": stats.core_ns * s,
        "compact_s": stats.compact_ns * s,
        "readback_s": stats.readback_ns * s,
        "readback_mb": stats.readback_bytes / 1e6,
        "format_s": stats.format_ns * s, "pairs": stats.num_pairs,
        "read_len": max(len(r.content) for r in reads),
        # no copy is timed on the CPU
        "h2d_mb_s": (stats.upload_bytes / stats.upload_ns * 1e3
                     if stats.upload_ns else ""),
        "d2h_mb_s": (stats.readback_bytes / stats.readback_ns * 1e3
                     if stats.readback_ns and dev.type == "cuda" else ""),
        "W": cfg.W, "batch_tile": cfg.batch_tile,
        "tiles": -(-stats.num_pairs // cfg.batch_tile),
        "engine": (engine.window_kernel(cfg).source if dev.type == "cuda"
                   else "plain"),
        "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "device_busy_share": "" if busy is None else busy}


def write_csv(path: str, rows) -> None:
    """Write rows (row()) to ``path`` under HEADER, the CSV that
    ``plots pipeline`` reads."""
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=HEADER)
        w.writeheader()
        w.writerows(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True, help="the CSV to write")
    p.add_argument("--device", default="cuda")
    p.add_argument("--reads", type=int, default=16384)
    p.add_argument("--read_len", type=int, default=10000)
    p.add_argument("--genome_len", type=int, default=1_000_000)
    p.add_argument("--batch_tile", type=int, default=1024)
    p.add_argument("--W", type=int, default=64)
    p.add_argument("--K", type=int, default=64)
    p.add_argument("--O", type=int, default=33)
    p.add_argument("--reps", type=int, default=1)
    p.add_argument("--trace", action="store_true",
                   help="add a traced call a mode (needs a card)")
    p.add_argument("--no_warmup", action="store_true",
                   help="time the process's first call too")
    p.add_argument("--decode_threads", type=int, default=None,
                   help="set api.DECODE_THREADS, to weigh it")
    args = p.parse_args(argv)
    if args.decode_threads:
        from scrooge_tpu_torch import api

        api.DECODE_THREADS = args.decode_threads

    cfg = st.AlignConfig(W=args.W, K=args.K, O=args.O,
                         batch_tile=args.batch_tile)
    ds = simulate_dataset(genome_len=args.genome_len, num_reads=args.reads,
                          read_len=args.read_len, accuracy=0.95, seed=7)
    prepared = st.prepare_genome(ds.genome)
    if not args.no_warmup:
        call(prepared, ds.reads, cfg, args.device, False)  # build, warm up
    rows = []
    with tempfile.TemporaryDirectory(prefix="scrooge_pipeline_") as tmp:
        for mode, packed in (("strings", False), ("packed", True)):
            for _ in range(args.reps):
                _, stats, wall = call(prepared, ds.reads, cfg, args.device,
                                      packed)
                busy = None
                if args.trace:
                    _, (_, _, busy, _) = traced_call(
                        prepared, ds.reads, cfg, args.device, packed,
                        os.path.join(tmp, "trace.json"))
                rows.append(row(mode, stats, wall, ds.reads, cfg,
                                args.device, busy))
                print(json.dumps(rows[-1]), flush=True)
    write_csv(args.out, rows)
    print(f"wrote {len(rows)} rows to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
