"""Kernel-only timing of the window engine on a CUDA card.

Port of scrooge_tpu/profiling/kernel_time.py:22-94: stage one read-mapping
batch on the device once, then time only engine launches with CUDA
events, N launches per sample and one synchronise; ``kernel_rate_samples``
gives the samples as aligns/second, as the sweeps record them, and
``kernel_rate`` their median. There is no CPU fallback: a device time
needs a device.

As a script it times the engine on the bench's dataset at several tiles,
in turns, which is how the bench's default kernel tile was chosen:

    python -m scrooge_tpu_torch.profiling.kernel_time \
        --tiles 16384 24576 32768 [--reads 32768 --read_len 10000 --W 64]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from ..api import PreparedGenome, _maxw, resolve_device
from ..ops import engine, pack


def stage_mapped(genome, reads, cfg, device="cuda"):
    """Stage ``cfg.batch_tile`` reads (one candidate location each) on a
    CUDA device. Returns ``(cfg, maxw, args, n)`` for the timers, with
    ``args`` the device tensors engine.align_windows takes."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("kernel timing needs a CUDA device")
    reads = list(reads[: cfg.batch_tile])
    if not reads or any(len(r.locations) != 1 for r in reads):
        raise ValueError("stage_mapped takes reads with one location each")
    prepared = (genome if isinstance(genome, PreparedGenome)
                else PreparedGenome(genome))
    glen = len(prepared.reference.content)
    longest = max(len(r.content) for r in reads) or 1
    maxw = _maxw(cfg, longest)
    starts = np.array([r.locations[0].start_in_reference for r in reads],
                      np.int64)
    tlen = np.minimum(glen - starts, maxw * cfg.tb_limit + cfg.W).astype(
        np.int32)
    plen = np.array([len(r.content) for r in reads], np.int32)
    words = pack.encode_pack_host([r.content for r in reads], longest)
    args = (prepared.device_words(dev), torch.from_numpy(starts).to(dev),
            torch.from_numpy(tlen).to(dev), pack.to_device(words, dev),
            torch.from_numpy(plen).to(dev))
    torch.cuda.synchronize(dev)
    return cfg, maxw, args, len(reads)


def engine_ms(staged, reps: int = 3, groups: int = 3):
    """Milliseconds per engine call for each of ``groups`` samples of
    ``reps`` calls, after one warm-up call. The events are recorded on
    the staged tensors' card, whichever card is current."""
    cfg, maxw, args, _ = staged
    if not args[3].is_cuda:
        raise RuntimeError("kernel timing needs a CUDA device")
    with torch.cuda.device(args[3].device):
        engine.align_windows(cfg, maxw, *args)
        samples = []
        for _ in range(max(groups, 1)):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                engine.align_windows(cfg, maxw, *args)
            t1.record()
            t1.synchronize()
            samples.append(t0.elapsed_time(t1) / reps)
    return samples


def kernel_rate_samples(staged, reps: int = 4, groups: int = 3):
    """Engine-only aligns/second of each of ``groups`` samples of ``reps``
    calls (engine_ms), for callers that record min/median/max
    (scrooge_tpu/profiling/kernel_time.py:62)."""
    n = staged[3]
    return [n * 1e3 / ms for ms in engine_ms(staged, reps, groups)]


def kernel_rate(staged, reps: int = 4) -> float:
    """Median engine-only aligns/second over 3 sample groups
    (kernel_rate_samples; scrooge_tpu/profiling/kernel_time.py:91-94)."""
    return float(np.median(kernel_rate_samples(staged, reps)))


def main(argv=None) -> int:
    """Time the engine at each tile of ``--tiles`` on the bench's dataset
    (W, K = W, O = W//2+1), three rounds in turns of 3 x 6 calls a tile;
    prints a JSON line a tile and the fastest by median."""
    p = argparse.ArgumentParser(
        description="kernel-only aligns/s of the bench dataset by tile")
    p.add_argument("--tiles", type=int, nargs="+", required=True)
    p.add_argument("--reads", type=int, default=32768)
    p.add_argument("--read_len", type=int, default=10000)
    p.add_argument("--W", type=int, default=64)
    args = p.parse_args(argv)
    from ..config import AlignConfig
    from ..utils.simulate import simulate_dataset

    dev = resolve_device("cuda")
    cfg = AlignConfig(W=args.W, K=args.W, O=args.W // 2 + 1)
    ds = simulate_dataset(genome_len=1_000_000, num_reads=args.reads,
                          read_len=args.read_len, accuracy=0.95, seed=7)
    genome = PreparedGenome(ds.genome)
    staged = {t: stage_mapped(genome, ds.reads,
                              dataclasses.replace(cfg, batch_tile=t), dev)
              for t in args.tiles}
    rates = {t: [] for t in args.tiles}
    for _ in range(3):  # in turns, so drift reaches every tile alike
        for t in args.tiles:
            rates[t] += kernel_rate_samples(staged[t], 6, 3)
    median = {t: sorted(r)[len(r) // 2] for t, r in rates.items()}
    for t in args.tiles:
        print(json.dumps({"tile": t, "pairs": staged[t][3], "W": cfg.W,
                          "read_len": args.read_len, "median": median[t],
                          "min": min(rates[t]), "max": max(rates[t]),
                          "samples": len(rates[t])}))
    print(json.dumps({"fastest_tile": max(args.tiles, key=median.get),
                      "card": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
