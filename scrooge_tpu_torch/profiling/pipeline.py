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
share of the call, and prints to stderr where the device's idle time lies
among the program's host spans (``idle_by_span``) and what each thread's
spans sum to against the call's wall (``span_sums``).

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
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

import torch

import scrooge_tpu_torch as st
from scrooge_tpu_torch.ops import engine
from scrooge_tpu_torch.profiling import spans
from scrooge_tpu_torch.utils.simulate import simulate_dataset

HEADER = ["mode", "wall_s", "prep_s", "upload_s", "upload_mb", "core_s",
          "compact_s", "readback_s", "readback_mb", "format_s", "pairs",
          "read_len", "h2d_mb_s", "d2h_mb_s",
          # what ran, beside the JAX columns
          "W", "batch_tile", "tiles", "engine", "card", "device_busy_share"]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_SPAN = "no span"


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
    events, (t0, t1), _ = _call_window(path)
    busy = sum(b - a for a, b in _busy(events, t0, t1))
    window = [e for e in events if e.get("cat") == "kernel"
              and kernel in e.get("name", "")]
    return (len(window), sum(float(e["dur"]) for e in window) / 1e3,
            busy / (t1 - t0), (t1 - t0) / 1e3)


def _call_window(path: str):
    """(the trace's complete events, (start, end) in us of its
    ``align_reads`` annotation, the annotation's thread)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    span = next(e for e in events if e.get("name") == "align_reads"
                and e.get("cat") == "user_annotation")
    t0 = float(span["ts"])
    return events, (t0, t0 + float(span["dur"])), span["tid"]


def _union(intervals, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The merged intervals of ``intervals`` clipped to [t0, t1]."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _busy(events, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The device's busy intervals: kernels, copies and sets on every
    stream, merged, within [t0, t1]."""
    return _union(((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") in DEVICE_CATS), t0, t1)


def _host_spans(events, caller_tid):
    """{thread name: [(start, end, stage, call id)]} of the program's
    ``scrooge.*`` ranges (profiling/spans.py), by start. The thread of the
    ``align_reads`` annotation is "caller", the others "worker", or
    "worker <k>" in the order of their first range where there are
    several."""
    by_tid = defaultdict(list)
    for e in events:
        if (e.get("cat") == "user_annotation"
                and e["name"].startswith(spans.PREFIX)):
            stage, call, _ = spans.parse(e["name"])
            a = float(e["ts"])
            by_tid[e["tid"]].append((a, a + float(e["dur"]), stage, call))
    others = sorted((min(x[0] for x in v), tid) for tid, v in by_tid.items()
                    if tid != caller_tid)
    names = {caller_tid: "caller"}
    for k, (_, tid) in enumerate(others):
        names[tid] = "worker" if len(others) == 1 else f"worker {k + 1}"
    return {names[tid]: sorted(v, key=lambda x: (x[0], -x[1]))
            for tid, v in by_tid.items()}


def _innermost(ranges, a: float, b: float) -> Dict[str, float]:
    """{stage: us} of [a, b] put down to the innermost range open at each
    instant (the latest started: ranges nest on one thread), NO_SPAN
    where none is."""
    inside = [r for r in ranges if r[0] < b and r[1] > a]
    cuts = sorted({a, b} | {x for r in inside for x in r[:2] if a < x < b})
    out: Dict[str, float] = defaultdict(float)
    for p, q in zip(cuts, cuts[1:]):
        m = (p + q) / 2
        open_ = [r for r in inside if r[0] <= m < r[1]]
        inner = max(open_, key=lambda r: (r[0], -r[1]), default=None)
        out[inner[2] if inner else NO_SPAN] += q - p
    return out


class IdleReport(NamedTuple):
    """Where the device was idle within a traced ``align_reads`` call."""
    window_s: float
    idle_s: float
    # {thread: {stage: idle seconds}}; each thread's sum is idle_s
    by_span: Dict[str, Dict[str, float]]
    # the longest idle gaps: (start after the call's start s, length s,
    # {thread: the stage that overlaps the gap most})
    gaps: List[Tuple[float, float, Dict[str, str]]]
    kernel_s: float        # kernels' durations, summed
    kernel_union_s: float  # the union of the kernels' intervals


def idle_by_span(path: str, n_gaps: int = 10) -> IdleReport:
    """From a torch.profiler chrome trace of an ``align_reads``-annotated
    call: each interval in which the device ran nothing (trace_shares'
    busy union) put down to the innermost ``scrooge.*`` range open on each
    host thread at that time, or NO_SPAN. A kernel sum above the kernels'
    union means kernels overlapped (the two tiles' streams)."""
    events, (t0, t1), caller = _call_window(path)
    edges = [t0] + [x for ab in _busy(events, t0, t1) for x in ab] + [t1]
    idle = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    threads = _host_spans(events, caller)
    by_span = {}
    for name, ranges in threads.items():
        acc: Dict[str, float] = defaultdict(float)
        for a, b in idle:
            for stage, us in _innermost(ranges, a, b).items():
                acc[stage] += us / 1e6
        by_span[name] = dict(sorted(acc.items(), key=lambda x: -x[1]))
    gaps = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:n_gaps]:
        most = {name: max(_innermost(ranges, a, b).items(),
                          key=lambda x: x[1])[0]
                for name, ranges in threads.items()}
        gaps.append(((a - t0) / 1e6, (b - a) / 1e6, most))
    kernels = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in events if e.get("cat") == "kernel"]
    return IdleReport(
        (t1 - t0) / 1e6, sum(b - a for a, b in idle) / 1e6, by_span, gaps,
        sum(min(b, t1) - max(a, t0) for a, b in kernels
            if min(b, t1) > max(a, t0)) / 1e6,
        sum(b - a for a, b in _union(kernels, t0, t1)) / 1e6)


def span_sums(path: str) -> Dict[int, dict]:
    """Per call id of a traced ``align_reads`` call: its ``scrooge.call``
    wall and, for each thread, the seconds of each stage whose range no
    other stage's range holds (a nested range counts once, in the one
    that holds it), so a thread's stages sum to at most the time it
    spent in the call."""
    events, _, caller = _call_window(path)
    out: Dict[int, dict] = {}
    for name, ranges in _host_spans(events, caller).items():
        end = float("-inf")
        for a, b, stage, call in ranges:
            rec = out.setdefault(call, {"wall_s": 0.0, "threads": {}})
            if stage == spans.PREFIX + "call":
                rec["wall_s"] = (b - a) / 1e6
                continue
            if a < end:  # inside the stage before it
                continue
            end = b
            th = rec["threads"].setdefault(name, defaultdict(float))
            th[stage] += (b - a) / 1e6
    return out


def traced_call(prepared, reads, cfg, device, packed: bool, path: str):
    """call() under torch.profiler (host and device activity, every
    thread's ranges where torch can: spans.profile), the call annotated
    ``align_reads``; the trace is written to ``path``. Returns call()'s
    result and trace_shares(path)."""
    from torch.profiler import record_function

    _sync(device)
    with spans.profile(cuda=_first(device).type == "cuda") as prof:
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


def print_spans(mode: str, path: str) -> None:
    """Print idle_by_span and span_sums of a traced call to stderr."""
    rep = idle_by_span(path)
    err = sys.stderr
    print(f"# {mode}: window {rep.window_s:.6f} s, device idle "
          f"{rep.idle_s:.6f} s; kernels {rep.kernel_s:.6f} s summed, "
          f"{rep.kernel_union_s:.6f} s as a union (overlap "
          f"{rep.kernel_s - rep.kernel_union_s:.6f} s)", file=err)
    for thread, by in rep.by_span.items():
        print(f"# {mode}: idle s by {thread} span: "
              + ", ".join(f"{k} {v:.6f}" for k, v in by.items()), file=err)
    for at, length, where in rep.gaps:
        print(f"# {mode}: idle gap at {at:.6f} s, {length:.6f} s: "
              + ", ".join(f"{t} {k}" for t, k in where.items()), file=err)
    for call, rec in span_sums(path).items():
        for thread, by in rec["threads"].items():
            total = sum(by.values())
            share = total / rec["wall_s"] if rec["wall_s"] else float("nan")
            print(f"# {mode}: call {call} {thread} stages {total:.6f} s of "
                  f"the call's {rec['wall_s']:.6f} s ({share:.4f}): "
                  + ", ".join(f"{k} {v:.6f}" for k, v in by.items()),
                  file=err)


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
                   help="add a traced call a mode, and print where the "
                   "device idles among the host spans")
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
                    path = os.path.join(tmp, "trace.json")
                    _, (_, _, busy, _) = traced_call(
                        prepared, ds.reads, cfg, args.device, packed, path)
                    print_spans(mode, path)
                rows.append(row(mode, stats, wall, ds.reads, cfg,
                                args.device, busy))
                print(json.dumps(rows[-1]), flush=True)
    write_csv(args.out, rows)
    print(f"wrote {len(rows)} rows to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
