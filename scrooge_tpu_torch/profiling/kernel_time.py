"""Kernel-only timing of the window engine on a CUDA card.

Port of scrooge_tpu/profiling/kernel_time.py:22-94: stage one read-mapping
batch on the device once, then time only engine launches with CUDA
events, N launches per sample and one synchronise; ``kernel_rate_samples``
gives the samples as aligns/second, as the sweeps record them. There is
no CPU fallback: a device time needs a device.
"""

from __future__ import annotations

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
