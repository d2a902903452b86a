"""Smoke run of the torch port on one NVIDIA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py

Phases, one line each:
  1. toolchain: torch, CUDA, nvcc, triton, and the card as nvidia-smi
     reports it (its own line);
  2. build: compile the window kernel from csrc/ with nvcc;
  3. kernel against plain: the CUDA kernel and the plain torch engine on
     the same device tensors, 512 pairs of ~1 kbp at W/K/O 64/64/33 and
     32/32/17, then the main path's own tile (16384 reads of 10 kbp);
     every output must be identical;
  4. main path: align_reads on the bench workload (simulate_dataset(
     1 Mbp genome, 16384 reads x 10 kbp, 95 % accuracy, seed 7), W=64
     K=64 O=33, one tile of 16384), strings then packed; the kernel's
     launch count must grow, both outputs must agree, sampled pairs must
     equal pyref and carry valid CIGARs;
  5. kernel-only time of the same tile, CUDA events;
  6. the README's quick-start pair.

Then the kernels' JSON line, the card line again, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without a CUDA device the script exits 1 and prints no result. It imports
no JAX: its oracles are scrooge_tpu.pyref, scrooge_tpu.cigar and the
port's plain engine.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

SOURCE = "scrooge_tpu_torch/csrc/genasm_windows.cu"
REPLACES = "scrooge_tpu/ops/engine_pallas.py:901"


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nvcc_release() -> str:
    from scrooge_tpu_torch.ops import _cuda

    out = subprocess.run([_cuda.find_nvcc(), "--version"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return next((ln.split("release")[1].split(",")[0].strip()
                 for ln in out.splitlines() if "release" in ln), "unknown")


def max_abs_diff(a, b) -> int:
    """Largest absolute difference over every output of two BatchResults,
    runs compared after compaction (entries past a window's count are
    not part of the result)."""
    from scrooge_tpu_torch.ops import compact

    diffs = [int((x.long() - y.long()).abs().max().item())
             for x, y in ((a.edit_distance, b.edit_distance),
                          (a.failed, b.failed), (a.counts, b.counts))]
    cap = max(int(a.counts.sum(0).max().item()),
              int(b.counts.sum(0).max().item()), 1)
    ca, ta = compact.compact_entries(a.entries, a.counts, cap)
    cb, tb = compact.compact_entries(b.entries, b.counts, cap)
    diffs += [int((ta.long() - tb.long()).abs().max().item()),
              int((ca.long() - cb.long()).abs().max().item())]
    return max(diffs)


def timed(fn, *args):
    """(result, milliseconds) of one call, timed with CUDA events."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn(*args)
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def random_pairs(cfg, seed, dev, B=512, length=1000, rate=0.05):
    """B pairs of ~length bp with substitutions and indels, staged."""
    from scrooge_tpu_torch.ops import pack

    rng = np.random.default_rng(seed)
    T = length + 100
    text = rng.integers(0, 4, (B, T), dtype=np.uint8)
    pattern = np.zeros((B, length + 60), np.uint8)
    plen = np.zeros(B, np.int32)
    for b in range(B):
        r = rng.random(T)
        keep = text[b][r >= rate / 3]  # deletions
        sub = rng.random(len(keep)) < rate / 3
        keep = np.where(sub, rng.integers(0, 4, len(keep)), keep)
        ins = np.flatnonzero(rng.random(len(keep)) < rate / 3)
        q = np.insert(keep, ins, rng.integers(0, 4, len(ins)))
        q = q[: int(rng.integers(length - 50, length + 50))]
        pattern[b, : len(q)] = q
        plen[b] = len(q)
    tlen = np.full(B, T, np.int32)
    tw = pack.pack_2bit(torch.from_numpy(text)).to(dev)
    base = torch.arange(B, dtype=torch.int64, device=dev) * (tw.shape[1] * 16)
    maxw = -(-cfg.max_windows(int(plen.max())) // 32) * 32
    return maxw, (tw, base, torch.from_numpy(tlen).to(dev),
                  pack.pack_2bit(torch.from_numpy(pattern)).to(dev),
                  torch.from_numpy(plen).to(dev))


def compare(cfg, maxw, args, label):
    """Kernel wrapper and plain engine on the same device tensors."""
    from scrooge_tpu_torch.ops import engine

    engine.align_windows(cfg, maxw, *args)  # warm the launch path
    got, ms = timed(engine.align_windows, cfg, maxw, *args)
    want, plain_ms = timed(engine.align_windows_plain, cfg, maxw, *args)
    err = max_abs_diff(got, want)
    failed = int((got.failed != 0).sum().item())
    phase("kernel-vs-plain", shape=label, W=cfg.W, K=cfg.K, O=cfg.O,
          B=int(args[4].shape[0]), maxw=maxw, kernel_ms=f"{ms:.3f}",
          plain_ms=f"{plain_ms:.3f}", max_abs_err=err, tolerance=0,
          failed_lanes=failed)
    if err != 0:
        raise AssertionError(f"kernel and plain engine differ ({label})")
    return ms, plain_ms, err


def packed_cigars(packed):
    """All CIGAR strings of a PackedAlignments via the native formatter."""
    from scrooge_tpu import native

    lens = np.diff(packed.run_offsets).astype(np.int32)
    n = len(lens)
    buf = np.zeros((max(int(lens.max(initial=0)), 1), n), np.uint16)
    lane = np.repeat(np.arange(n), lens)
    pos = np.arange(len(packed.runs)) - np.repeat(packed.run_offsets[:-1],
                                                  lens)
    buf[pos, lane] = packed.runs
    out = native.format_cigars(buf, lens)
    if out is None:
        raise RuntimeError("scrooge_tpu.native is unavailable")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import scrooge_tpu_torch as st
    from scrooge_tpu import pyref
    from scrooge_tpu.cigar import is_valid_cigar
    from scrooge_tpu.utils.simulate import simulate_dataset
    from scrooge_tpu_torch.ops import _cuda
    from scrooge_tpu_torch.profiling import kernel_time

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 1. toolchain ----
    try:
        import triton  # noqa: F401

        has_triton = True
    except ImportError:
        has_triton = False
    card = nvidia_smi()
    phase("toolchain", torch=torch.__version__, cuda=torch.version.cuda,
          device=repr(kind), nvcc=nvcc_release(), triton=has_triton)
    print(card, flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    _cuda.GENASM_WINDOWS.build()
    ptxas = " | ".join(ln.strip() for ln in
                       _cuda.GENASM_WINDOWS.build_log.splitlines()
                       if "registers" in ln or "spill" in ln)
    phase("build", kernel="genasm_windows",
          seconds=f"{time.perf_counter() - t0:.2f}", ptxas=repr(ptxas))

    # ---- 3. kernel against plain ----
    for W, K, O in ((64, 64, 33), (32, 32, 17)):
        cfg = st.AlignConfig(W=W, K=K, O=O)
        maxw, args = random_pairs(cfg, W, dev)
        compare(cfg, maxw, args, "512x1kbp")

    cfg = st.AlignConfig(W=64, K=64, O=33, early_termination=True,
                         batch_tile=16384)
    t0 = time.perf_counter()
    ds = simulate_dataset(genome_len=1_000_000, num_reads=16384,
                          read_len=10000, accuracy=0.95, seed=7)
    prepared = st.prepare_genome(ds.genome)
    staged = kernel_time.stage_mapped(prepared, ds.reads, cfg, dev)
    phase("dataset", reads=len(ds.reads),
          seconds=f"{time.perf_counter() - t0:.2f}")
    main_ms, main_plain_ms, main_err = compare(cfg, staged[1], staged[2],
                                               "main-path tile")

    # ---- 4. main path ----
    _cuda.GENASM_WINDOWS.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strs, stats = st.align_reads(prepared, ds.reads, cfg, return_stats=True,
                                 device=dev)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed, pstats = st.align_reads(prepared, ds.reads, cfg,
                                    return_stats=True, return_packed=True,
                                    device=dev)
    pwall = time.perf_counter() - t0
    launches = _cuda.GENASM_WINDOWS.launches
    if launches < 1:
        raise AssertionError("the main path never launched the kernel")
    n = len(ds.reads)
    if [a.cigar for a in strs] != packed_cigars(packed) or not np.array_equal(
            np.array([a.edit_distance for a in strs]),
            packed.edit_distances):
        raise AssertionError("strings and packed output disagree")
    lens = [len(r.content) for r in ds.reads]
    rng = random.Random(7)
    sample = sorted({int(np.argmax(lens))} | set(rng.sample(range(n), 15)))
    bound = lambda r: cfg.max_windows(len(r.content)) * cfg.tb_limit + cfg.W
    for i in sample:
        r = ds.reads[i]
        s = r.locations[0].start_in_reference
        want = pyref.genasm(pyref.encode(ds.genome.content[s : s + bound(r)]),
                            pyref.encode(r.content), cfg)
        if (strs[i].edit_distance, strs[i].cigar) != want:
            raise AssertionError(f"pair {i} differs from pyref")
    for i in rng.sample(range(n), 512):
        r = ds.reads[i]
        if not is_valid_cigar(strs[i].cigar, strs[i].edit_distance,
                              ds.genome.content, r.content,
                              r.locations[0].start_in_reference):
            raise AssertionError(f"pair {i} has an invalid CIGAR")
    phase("main-path", pairs=n, launches=launches,
          retried_pairs=stats.retried_pairs, pyref_exact=len(sample),
          valid_cigars=512, wall_s=f"{wall:.3f}",
          aligns_per_s=f"{n / wall:.1f}", packed_wall_s=f"{pwall:.3f}",
          packed_aligns_per_s=f"{n / pwall:.1f}",
          breakdown=repr(stats.breakdown()),
          packed_breakdown=repr(pstats.breakdown()))

    # ---- 5. kernel-only time ----
    samples = kernel_time.engine_ms(staged, reps=3, groups=3)
    rates = sorted(n * 1e3 / ms for ms in samples)
    phase("kernel-only", tile=n, ms=" ".join(f"{x:.3f}" for x in samples),
          aligns_per_s=f"{rates[1]:.1f}", min=f"{rates[0]:.1f}",
          max=f"{rates[-1]:.1f}")

    # ---- 6. quick-start pair ----
    a = st.align_pairs(["AAAACCCCGGGGTTTT"], ["CCCCGGGGTTTTAAAA"],
                       device=dev)[0]
    phase("quick-start", edit_distance=a.edit_distance, cigar=a.cigar)
    if (a.edit_distance, a.cigar) != (8, "4D12=4I"):
        raise AssertionError("quick-start pair differs from 8 4D12=4I")

    print(json.dumps({"kernels": [{
        "name": "genasm_windows", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": main_err,
        "ms": main_ms, "plain_ms": main_plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
