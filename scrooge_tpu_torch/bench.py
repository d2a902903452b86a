"""Headline benchmark of the port: read-mapping throughput on one card.

    python -m scrooge_tpu_torch.bench

The counterpart of the JAX package's bench.py, section by section. The
workload mirrors the reference's headline GPU benchmark: PBSIM2-style
reads (``utils/simulate.simulate_dataset``, seed 7; by default 32,768
reads of 10 kbp at 95 % accuracy) mapped to a 1 Mbp genome at the
reference's representative long-read config, W=64 O=33 K=64 with early
termination. Baseline: 25,004 aligns/s, the reference CUDA kernel's
example throughput on an RTX 3060, kernel-only as the headline is here.

Knobs, from the environment (the JAX bench's names and defaults):

  BENCH_READS 32768, BENCH_READ_LEN 10000, BENCH_GENOME 1000000,
  BENCH_ACCURACY 0.95, BENCH_W 64 (K = W), BENCH_O W//2+1,
  BENCH_TILE 16384 (align_reads' batch_tile), BENCH_DECOYS 0 (Poisson
  extra candidates a read at random positions: the chained model),
  BENCH_KERNEL_TILE (pairs of the kernel-only pass; KERNEL_TILE_LONG for
  reads of 1 kbp and more, else KERNEL_TILE_SHORT), BENCH_PIPELINE_CSV
  (where the stage breakdown goes; unset, nowhere), BENCH_DEVICE cuda
  (the current card; "cuda:N" another; "cpu" runs the plain engine).
  BENCH_TBCAP other than 0 is refused: the port has no traceback cap.

Passes, in order:

  1. warm-up: align_reads twice over the whole dataset (the first builds
     the kernels, and pays for the decode threads' fresh malloc arenas),
     both walls on stderr;
  2. end to end: ROUNDS rounds of align_reads, strings then packed, each
     mode after gc.collect(); the best wall of each mode is kept. The
     first round's output is checked outside every timing (check_output:
     CHECK_PAIRS pairs against pyref, the longest read among them,
     CHECK_CIGARS CIGARs valid, packed equal to strings); a failed check
     exits 1 with no JSON line;
  3. kernel-only (a card only): the first kernel-tile pairs staged on
     the card (profiling/kernel_time.stage_mapped), KERNEL_GROUPS samples
     of KERNEL_REPS engine calls, each timed with CUDA events; the median
     is the headline ``value``. Every (read, location) pair is staged as
     a one-location read, the pairs align_reads aligns, so BENCH_DECOYS
     keeps the kernel-only pass (the JAX bench falls back to the API's
     core rate there);
  4. staged (a card only): the whole result pipeline on the staged
     inputs (engine.align_windows, then api._build_alignments on the
     API's decode threads), strings and packed, best of STAGED_REPS.

Without a card (BENCH_DEVICE=cpu) there is no kernel-only or staged pass:
``value`` is the API's aligns_per_second, as in the JAX bench when it
cannot stage, the link rates are null (nothing is copied) and ``card`` is
"cpu". With BENCH_DEVICE=cuda and no card, the bench raises.

Prints ONE JSON line on stdout, the JAX bench's keys (KEYS) and ``card``,
the card's name and power limit as nvidia-smi gives them. On stderr: the
warm-up walls, the summary and both modes' AlignStats breakdowns, the
staged breakdowns, the kernel tile, and each pass's kernel launches.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import os
import random
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import api, native, pyref
from .api import align_reads
from .cigar import is_valid_cigar
from .config import AlignConfig
from .datamodel import Read
from .ops import _cuda, engine
from .parallel.mesh import resolve_device
from .profiling import kernel_time, pipeline
from .utils.simulate import simulate_dataset

BASELINE_ALIGNS_PER_S = 25_004.0
KERNEL_REPS = 6
KERNEL_GROUPS = 3
ROUNDS = 3
STAGED_REPS = 2
CHECK_PAIRS = 16
CHECK_CIGARS = 512
# the kernel-only pass's default tiles: the fastest of 16,384, 24,576 and
# 32,768 on an H100 (profiling/kernel_time.py's probe, PERF.md); the JAX
# bench's 24,576 and 32,768 were tuned on a TPU
KERNEL_TILE_LONG = 16384
KERNEL_TILE_SHORT = 32768

# the JSON line's keys (the JAX bench's): always, on a card, long reads
KEYS = ("metric", "value", "unit", "gcups_equivalent",
        "api_core_aligns_per_second", "end_to_end_aligns_per_second",
        "end_to_end_packed_aligns_per_second", "link_h2d_mb_s",
        "link_d2h_mb_s", "card")
CARD_KEYS = ("kernel_aligns_min", "kernel_aligns_max",
             "staged_aligns_per_second", "staged_packed_aligns_per_second")
LONG_READ_KEYS = ("vs_baseline",)


class CheckError(AssertionError):
    """The bench's output disagrees with its oracles."""


@dataclasses.dataclass(frozen=True)
class Knobs:
    reads: int
    read_len: int
    genome_len: int
    accuracy: float
    decoys: float
    cfg: AlignConfig
    kernel_tile: int
    device: torch.device
    pipeline_csv: str


def knobs(env=os.environ) -> Knobs:
    """The bench's knobs from ``env`` (module doc). Raises ValueError for
    BENCH_TBCAP other than 0, and RuntimeError for a CUDA device where
    there is none, before anything is simulated."""
    tb_cap = int(env.get("BENCH_TBCAP", "0"))
    if tb_cap != 0:
        raise ValueError(f"BENCH_TBCAP={tb_cap}: the port has no traceback "
                         "cap (every kernel searches the full K)")
    device = resolve_device(env.get("BENCH_DEVICE", "cuda"))
    W = int(env.get("BENCH_W", "64"))
    cfg = AlignConfig(W=W, K=W, O=int(env.get("BENCH_O", str(W // 2 + 1))),
                      early_termination=True,
                      batch_tile=int(env.get("BENCH_TILE", "16384")))
    read_len = int(env.get("BENCH_READ_LEN", "10000"))
    default_tile = KERNEL_TILE_LONG if read_len >= 1000 else KERNEL_TILE_SHORT
    return Knobs(
        reads=int(env.get("BENCH_READS", "32768")), read_len=read_len,
        genome_len=int(float(env.get("BENCH_GENOME", "1000000"))),
        accuracy=float(env.get("BENCH_ACCURACY", "0.95")),
        decoys=float(env.get("BENCH_DECOYS", "0")), cfg=cfg,
        kernel_tile=int(env.get("BENCH_KERNEL_TILE", str(default_tile))),
        device=device, pipeline_csv=env.get("BENCH_PIPELINE_CSV", ""))


def dataset(k: Knobs):
    return simulate_dataset(genome_len=k.genome_len, num_reads=k.reads,
                            read_len=k.read_len, accuracy=k.accuracy, seed=7,
                            decoys=k.decoys)


def pair_reads(reads):
    """Each (read, candidate location) as a one-location read, in the
    order align_reads returns their alignments."""
    return [Read(r.description, r.content, [loc])
            for r in reads for loc in r.locations]


def packed_cigars(packed):
    """All CIGAR strings of a PackedAlignments via the native formatter."""
    lens = np.diff(packed.run_offsets).astype(np.int32)
    n = len(lens)
    buf = np.zeros((max(int(lens.max(initial=0)), 1), n), np.uint16)
    lane = np.repeat(np.arange(n), lens)
    pos = np.arange(len(packed.runs)) - np.repeat(packed.run_offsets[:-1],
                                                  lens)
    buf[pos, lane] = packed.runs
    return native.format_cigars(buf, lens)


def check_sample(lens, nsample: int, ncigar: int, seed: int = 7):
    """(pairs held to pyref, sorted, the longest among them; pairs whose
    CIGAR is validated) among pairs of lengths ``lens``."""
    n = len(lens)
    rng = random.Random(seed)
    sample = sorted({int(np.argmax(lens))}
                    | set(rng.sample(range(n), min(nsample - 1, n))))
    return sample, rng.sample(range(n), min(ncigar, n))


def check_output(genome: str, pairs, cfg: AlignConfig, strs, packed,
                 nsample: int = CHECK_PAIRS, ncigar: int = CHECK_CIGARS,
                 label: str = "bench"):
    """Hold align_reads' output for ``pairs`` (one-location reads, see
    pair_reads) to its oracles: the strings output ``strs`` equal to the
    packed one, ``nsample`` pairs (check_sample) equal to pyref on the
    text the engine reads, ``ncigar`` CIGARs valid against the genome.
    Raises CheckError; returns (pairs held to pyref, CIGARs validated)."""
    n = len(pairs)
    if len(strs) != n or len(packed) != n:
        raise CheckError(f"{label}: {len(strs)} strings and {len(packed)} "
                         f"packed alignments for {n} pairs")
    if [a.cigar for a in strs] != packed_cigars(packed) or not np.array_equal(
            np.array([a.edit_distance for a in strs]),
            packed.edit_distances):
        raise CheckError(f"{label}: strings and packed output disagree")
    sample, cigars = check_sample([len(r.content) for r in pairs], nsample,
                                  ncigar)
    for i in sample:
        r = pairs[i]
        s = r.locations[0].start_in_reference
        bound = cfg.max_windows(len(r.content)) * cfg.tb_limit + cfg.W
        want = pyref.genasm(pyref.encode(genome[s : s + bound]),
                            pyref.encode(r.content), cfg)
        if (strs[i].edit_distance, strs[i].cigar) != want:
            raise CheckError(f"{label}: pair {i} differs from pyref")
    for i in cigars:
        r = pairs[i]
        if not is_valid_cigar(strs[i].cigar, strs[i].edit_distance, genome,
                              r.content, r.locations[0].start_in_reference):
            raise CheckError(f"{label}: pair {i} has an invalid CIGAR")
    return len(sample), len(cigars)


def card_label(dev: torch.device) -> str:
    """'name, power limit' of the card as nvidia-smi reports them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index}"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def launches():
    """{kernel source: {launch key: launches so far}}."""
    return {k.source: collections.Counter(k.counts) for k in _cuda.KERNELS}


def since(before):
    """The launches made since ``before`` (launches()), non-zero only."""
    out = {}
    for src, now in launches().items():
        d = {key: n - before[src][key] for key, n in now.items()
             if n != before[src][key]}
        if d:
            out[src] = d
    return out


def staged_pass(staged):
    """(strings rate, packed rate): the whole result pipeline from inputs
    already on the card, best of STAGED_REPS after one warm call a mode;
    each mode's best breakdown goes to stderr."""
    cfg, maxw, args, n = staged
    pool = (ThreadPoolExecutor(max_workers=api.DECODE_THREADS)
            if api.DECODE_THREADS > 1 else None)

    def run_full(packed, stats):
        tns = time.perf_counter_ns()
        res = engine.align_windows(cfg, maxw, *args)
        _, payload, _ = api._build_alignments(cfg, res, stats, packed, tns,
                                              pool)
        return payload

    rates = []
    try:
        for packed in (False, True):
            gc.collect()
            run_full(packed, api.AlignStats(num_pairs=n))
            best, stats = 0.0, None
            for _ in range(STAGED_REPS):
                s = api.AlignStats(num_pairs=n)
                t0 = time.perf_counter()
                payload = run_full(packed, s)
                rate = n / (time.perf_counter() - t0)
                if rate > best:
                    best, stats = rate, s
            got = len(payload[1]) - 1 if packed else len(payload)
            if got != n:
                raise CheckError(f"staged pass: {got} alignments for {n}")
            rates.append(best)
            print(f"# staged[{'packed' if packed else 'strings'}]: "
                  f"{stats.breakdown()}", file=sys.stderr)
    finally:
        if pool is not None:
            pool.shutdown()
    return rates[0], rates[1]


def main() -> int:
    """Run the bench (module doc); 1 when its output fails a check."""
    k = knobs()
    try:
        run(k)
    except CheckError as e:
        print(f"# output check failed: {e}", file=sys.stderr)
        return 1
    return 0


def run(k: Knobs) -> None:
    """The passes of the module doc; prints the JSON line last."""
    cfg, dev = k.cfg, k.device
    ds = dataset(k)
    pairs = pair_reads(ds.reads)

    def call(packed):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out, stats = align_reads(ds.genome, ds.reads, cfg, return_stats=True,
                                 return_packed=packed, device=dev)
        return out, stats, time.perf_counter() - t0

    t_warm = []
    for _ in range(2):
        t_warm.append(call(False)[2])
    print(f"# warm-up: first call {t_warm[0]:.3f}s, "
          f"second call {t_warm[1]:.3f}s", file=sys.stderr)

    before = launches()
    wall_s = packed_wall_s = float("inf")
    stats = pstats = checked = None
    for rnd in range(ROUNDS):
        gc.collect()
        results, s_stats, w = call(False)
        if w < wall_s:
            wall_s, stats = w, s_stats
        n_out = len(results)
        if rnd:  # each mode pays for its own garbage; round 0 is checked
            results = None
        gc.collect()
        packed, p_stats, w = call(True)
        if w < packed_wall_s:
            packed_wall_s, pstats = w, p_stats
        if not len(packed) == s_stats.num_pairs == n_out == len(pairs):
            raise CheckError(f"round {rnd}: {n_out} strings and "
                             f"{len(packed)} packed alignments for "
                             f"{len(pairs)} pairs")
        if rnd == 0:
            checked = check_output(ds.genome.content, pairs, cfg, results,
                                   packed)
        results = packed = None
    passes = {"end_to_end": since(before)}

    kernel_samples = staged_rates = None
    ktile = 0
    if dev.type == "cuda":
        kcfg = dataclasses.replace(cfg, batch_tile=k.kernel_tile)
        staged = kernel_time.stage_mapped(ds.genome, pairs, kcfg, dev)
        ktile = staged[3]
        before = launches()
        kernel_samples = sorted(kernel_time.kernel_rate_samples(
            staged, KERNEL_REPS, KERNEL_GROUPS))
        passes["kernel_only"] = since(before)
        before = launches()
        staged_rates = staged_pass(staged)
        passes["staged"] = since(before)
        staged = None

    card = card_label(dev)
    out = result_line(k.read_len, stats, wall_s, packed_wall_s,
                      kernel_samples, staged_rates, card)
    link = (f"link[h2d={out['link_h2d_mb_s']:.0f}MB/s "
            f"d2h={out['link_d2h_mb_s']:.0f}MB/s]"
            if out["link_h2d_mb_s"] is not None
            else "link[not measured on the cpu]")
    print(f"# pairs={stats.num_pairs} kernel={out['value']:.1f} aligns/s "
          f"core={stats.core_ns / 1e9:.3f}s wall={wall_s:.3f}s "
          f"packed_wall={packed_wall_s:.3f}s "
          f"retried={stats.retried_pairs} "
          f"end_to_end={out['end_to_end_aligns_per_second']:.1f} aligns/s "
          f"end_to_end_packed="
          f"{out['end_to_end_packed_aligns_per_second']:.1f} aligns/s "
          f"gcups_equiv={out['gcups_equivalent']:.1f} {link}",
          file=sys.stderr)
    print(f"# {stats.breakdown()}", file=sys.stderr)
    print(f"# packed: {pstats.breakdown()}", file=sys.stderr)
    print(f"# checked: {checked[0]} pairs equal to pyref, {checked[1]} "
          "valid CIGARs, packed equal to strings", file=sys.stderr)
    if kernel_samples:
        print(f"# kernel tile={ktile} of {len(pairs)} pairs, "
              f"{KERNEL_GROUPS} groups x {KERNEL_REPS} calls: "
              + " ".join(f"{r:.1f}" for r in kernel_samples) + " aligns/s",
              file=sys.stderr)
        print(f"# staged: strings={staged_rates[0]:.1f} "
              f"packed={staged_rates[1]:.1f} aligns/s", file=sys.stderr)
    print("# launches " + json.dumps(passes), file=sys.stderr)
    if k.pipeline_csv:
        pipeline.write_csv(k.pipeline_csv, [
            pipeline.row("strings", stats, wall_s, ds.reads, cfg, dev),
            pipeline.row("packed", pstats, packed_wall_s, ds.reads, cfg,
                         dev)])
        print(f"# stage breakdown written to {k.pipeline_csv}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)


def result_line(read_len: int, stats, wall_s: float, packed_wall_s: float,
                kernel_samples, staged_rates, card: str) -> dict:
    """The JSON line (module doc) from the best strings round's AlignStats
    and the walls of both modes; ``kernel_samples`` (sorted) and
    ``staged_rates`` are None without a card."""
    aligns_per_s = (kernel_samples[len(kernel_samples) // 2]
                    if kernel_samples else stats.aligns_per_second)
    gcups = aligns_per_s * read_len * read_len / 1e9
    on_card = card != "cpu"
    out = {
        "metric": ("long_read" if read_len >= 1000 else "short_read")
                  + "_aligns_per_second",
        "value": round(aligns_per_s, 1),
        "unit": "aligns/s",
        "gcups_equivalent": round(gcups, 2),
        # core rate as the API accounts it (launch to the meta readback,
        # summed over tiles); the headline value is the kernel alone
        "api_core_aligns_per_second": round(stats.aligns_per_second, 1),
        "end_to_end_aligns_per_second": round(stats.num_pairs / wall_s, 1),
        "end_to_end_packed_aligns_per_second":
            round(stats.num_pairs / packed_wall_s, 1),
        # the copies' device time (upload) and the host's wait on them
        # (readback); nothing is copied on the cpu
        "link_h2d_mb_s": (round(stats.upload_bytes
                                / max(stats.upload_ns, 1) * 1e3, 1)
                          if on_card else None),
        "link_d2h_mb_s": (round(stats.readback_bytes
                                / max(stats.readback_ns, 1) * 1e3, 1)
                          if on_card else None),
    }
    if kernel_samples:
        out["kernel_aligns_min"] = round(kernel_samples[0], 1)
        out["kernel_aligns_max"] = round(kernel_samples[-1], 1)
        out["staged_aligns_per_second"] = round(staged_rates[0], 1)
        out["staged_packed_aligns_per_second"] = round(staged_rates[1], 1)
    if read_len >= 1000:
        out["vs_baseline"] = round(aligns_per_s / BASELINE_ALIGNS_PER_S, 4)
    out["card"] = card
    return out


if __name__ == "__main__":
    sys.exit(main())
