"""Parameter sweeps (scripts/profile.py analogue) on a torch device.

The port's own copy of scrooge_tpu/profiling/sweep.py (families :211-604,
main :604-708) with the same arguments, CSV file names and headers:

  throughput sweeps -> ["W", "O", "early termination", "batch",
                        "aligns/second", "engine",
                        "aligns/second min", "aligns/second max"]
  accuracy sweeps   -> ["W", "O", "pair_idx", "score"(, "cigar", "read",
                        "reference")]

What differs, and why:

- ``--device=cuda|cpu`` (default cuda) picks where every GenASM row runs,
  with no fallback between the two. The JAX target ``xla`` (its XLA
  engine) has as counterpart ``device --device=cpu``, the plain torch
  engine; the JAX-only families ``kernel`` (the Pallas kernel's kw x sk)
  and ``tbcap`` (its d-search cap) have no knob here and are not ported.
- The ``engine`` column names what ran: the CUDA kernel's source
  (``genasm_windows1``, ``genasm_windows``, ``genasm_windows_wide``, the
  one ``ops/engine.window_kernel`` picks, whose launch count must grow
  during the row) or ``plain``. A row is never written for an engine that
  did not run.
- ``batch`` is the number of pairs the row ran (the tile, or fewer when
  the dataset holds fewer reads).
- ``early termination`` is the config the row ran, and the engines honour
  it as the JAX ones do: an ET=True row stops each window's d-search at
  its first hit, an ET=False row fills every row 0..K (K = W in the WO
  and O families), with the same output. The two rows of a W measure
  the ablation, each under its own kernel instantiation
  (``ops/engine.kernel_key``).
- The run-buffer budget is half the device's free memory (host memory
  for --device=cpu), measured when the sweep starts, not a constant.
- A config or family that fails is printed on stderr, the sweep goes on
  to the next, and the exit code is 1 when anything failed.
- Throughput rows on the card are kernel-only (profiling/kernel_time:
  CUDA events, 3 groups of 4 launches of one staged tile) where every
  read has one candidate location, else the api's core accounting; on the
  CPU they are the api's core accounting.

Usage:
  python -m scrooge_tpu_torch.profiling.sweep device <dataset> [--device=cpu]
  python -m scrooge_tpu_torch.profiling.sweep accuracy <dataset> [--cigar]
  python -m scrooge_tpu_torch.profiling.sweep groundtruth <dataset>
  python -m scrooge_tpu_torch.profiling.sweep baselines <dataset>
  <dataset> is a subdirectory of --datasets_dir with reference.fasta,
  reads.fastq, candidates.[maf|paf] (profile.py:650 contract), or
  'simulated[:reads[:length[:decoys[:accuracy]]]]' for the built-in
  PBSIM2-style generator.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys
from datetime import datetime
from itertools import product
from pathlib import Path
from typing import List, Optional

import torch

from .. import api
from ..baselines import edlib_available
from ..cigar import affine_score
from ..config import AlignConfig
from ..ops import engine

SCORING = dict(match=2, mismatch=4, gap_open=4, gap_extend=2)
HOST_BASELINES = ["exact", "affine", "banded", "wfa", "gact", "edlib"]
THROUGHPUT_HEADER = ["W", "O", "early termination", "batch",
                     "aligns/second", "engine",
                     # spread over kernel_rate_samples' 3 independently
                     # synced groups (median is the aligns/second column);
                     # api-accounted rows carry the single measurement in
                     # all three columns
                     "aligns/second min", "aligns/second max"]


def csv_write(path, rows, header):
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _load(dataset: str, datasets_dir: Path, with_truth: bool = False):
    if dataset.startswith("simulated"):
        from ..utils.simulate import simulate_dataset

        parts = dataset.split(":")
        num = int(parts[1]) if len(parts) > 1 else 512
        rlen = int(parts[2]) if len(parts) > 2 else 10_000
        decoys = float(parts[3]) if len(parts) > 3 else 0.0
        # parts[4]: read accuracy; 0.95 is the PBSIM2 default the
        # reference benchmarks at (DATASETS.md:45-60), ~0.85 models ONT
        accuracy = float(parts[4]) if len(parts) > 4 else 0.95
        ds = simulate_dataset(genome_len=1_000_000, num_reads=num,
                              read_len=rlen, accuracy=accuracy, seed=11,
                              with_truth=with_truth, decoys=decoys)
        return ((ds.genome, ds.reads, ds.truth) if with_truth
                else (ds.genome, ds.reads))
    from .. import io as sio

    genome, reads = sio.load_dataset(datasets_dir / dataset)
    if not with_truth:
        return genome, reads
    from ..tools.cigar_tools import maf_truth_rows

    maf = datasets_dir / dataset / "candidates.maf"
    if not maf.exists():
        raise FileNotFoundError(
            "groundtruth accuracy needs a gapped candidates.maf "
            f"(none in {datasets_dir / dataset})")
    return genome, reads, maf_truth_rows(str(maf))


def engine_name(cfg: AlignConfig, dev: torch.device) -> str:
    """What runs the config's windows on ``dev``: the CUDA kernel's source
    without its suffix, or 'plain' for the torch engine on the CPU."""
    if dev.type == "cpu":
        return "plain"
    return os.path.splitext(engine.window_kernel(cfg).source)[0]


def run_buffer_budget(dev: torch.device) -> int:
    """Bytes a throughput row's run buffers may take: half the card's free
    memory (what torch's allocator holds unused counted as free), or half
    the host's available memory for the CPU."""
    if dev.type == "cuda":
        return engine.free_bytes(dev) // 2
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 2


def _max_batch_for(cfg: AlignConfig, read_len: int, budget: int) -> int:
    """Largest batch tile (a multiple of 128, at least 128) whose
    worst-case run buffers fit ``budget``: the engine's (maxw, NE, B)
    int16 runs with NE = 2*tb_limit+2, about twice that again in
    compaction temporaries, and the (maxw, B) int32 counts. The kernels'
    R and forefront scratch is not counted: ops/engine splits a launch
    whose scratch does not fit."""
    maxw = -(-cfg.max_windows(read_len) // 32) * 32
    per_lane = maxw * (engine.entry_rows(cfg) * 2 * 3 + 4)
    return max(128, int(budget // max(per_lane, 1)) // 128 * 128)


def _run_throughput(genome, reads, cfg: AlignConfig, data: List,
                    dev: torch.device) -> bool:
    """One throughput row of ``cfg`` over ``reads``; False (and the
    failure on stderr) when the config failed."""
    try:
        single = all(len(r.locations) == 1 for r in reads)
        if dev.type == "cuda":
            kern = engine.window_kernel(cfg)
            before = sum(kern.counts.values())
        if dev.type == "cuda" and single:
            # engine-only rate, what the reference's sweep metric measures
            # (the binary's kernel section, profile.py:55-63)
            from .kernel_time import kernel_rate_samples, stage_mapped

            samples = sorted(kernel_rate_samples(
                stage_mapped(genome, reads, cfg, dev)))
            rate = samples[len(samples) // 2]
            lo, hi = samples[0], samples[-1]
        else:  # the api's core accounting
            _, stats = api.align_reads(genome, reads, cfg, return_stats=True,
                                       device=dev)
            rate = lo = hi = stats.aligns_per_second
        if dev.type == "cuda" and sum(kern.counts.values()) == before:
            raise RuntimeError(f"{kern.source} never launched")
    except Exception as e:  # config failed: record nothing, keep sweeping
        print(f"W={cfg.W} O={cfg.O} batch={cfg.batch_tile}: config failed "
              f"({type(e).__name__}: {e})", file=sys.stderr)
        return False
    data.append([cfg.W, cfg.O, cfg.early_termination, len(reads),
                 round(rate, 1), engine_name(cfg, dev), round(lo, 1),
                 round(hi, 1)])
    return True


def _run_throughput_ladder(genome, reads, cfg: AlignConfig, data: List,
                           batch: int, dev: torch.device, budget: int,
                           failures: List[str]) -> None:
    """Run one full tile at the largest memory-safe batch <= ``batch``,
    halving on failure down to 1024 (tiles below 1024 run once); a config
    with no row is a failure."""
    read_len = max((len(r.content) for r in reads), default=1)
    b = min(batch, _max_batch_for(cfg, read_len, budget))
    if b < batch:
        print(f"W={cfg.W} O={cfg.O}: run buffers cap batch at {b}",
              file=sys.stderr)
    floor = min(1024, batch)
    b = max(b if batch >= 1024 else batch, floor)
    while b >= floor:
        # time exactly ONE full tile: pad lanes in a trailing tile are
        # real device time, and the reference sweep likewise times fully
        # occupied single runs
        cfg_b = dataclasses.replace(cfg, batch_tile=b)
        if _run_throughput(genome, reads[: min(len(reads), b)], cfg_b, data,
                           dev):
            return
        b //= 2
        if b >= floor:
            print(f"retrying W={cfg.W} O={cfg.O} at batch {b}",
                  file=sys.stderr)
    failures.append(f"W={cfg.W} O={cfg.O} ET={cfg.early_termination}")


def sweep_wo(genome, reads, dev, out: Path, max_experiments: int,
             repetitions: int, batch: int, budget: int, failures: List[str],
             max_W: int = 256):
    """W sweep with O = min(W//2+1, W-1) (profile.py:65-82), each W with
    and without ET."""
    gran = max(16, max_W // max(1, max_experiments))
    Ws = list(range(gran, max_W + 1, gran))
    data: List = []
    configs = list(product(Ws, [False, True]))
    for idx, (W, et) in enumerate(configs):
        print(f"[{datetime.now()}] sweep_wo {idx}/{len(configs)}",
              file=sys.stderr)
        cfg = AlignConfig(W=W, K=W, O=min(W // 2 + 1, W - 1),
                          early_termination=et, batch_tile=batch)
        for _ in range(repetitions):
            _run_throughput_ladder(genome, reads, cfg, data, batch, dev,
                                   budget, failures)
        csv_write(out, data, THROUGHPUT_HEADER)  # durable per config


def sweep_o(genome, reads, dev, out: Path, max_experiments: int,
            repetitions: int, batch: int, budget: int, failures: List[str],
            W: int = 64):
    gran = max(4, W // max(1, max_experiments))
    Os = [o for o in range(gran - 1, W, gran) if 0 <= o < W]
    data: List = []
    for idx, (O, et) in enumerate(product(Os, [False, True])):
        print(f"[{datetime.now()}] sweep_o {idx}", file=sys.stderr)
        cfg = AlignConfig(W=W, K=W, O=O, early_termination=et,
                          batch_tile=batch)
        for _ in range(repetitions):
            _run_throughput_ladder(genome, reads, cfg, data, batch, dev,
                                   budget, failures)
        csv_write(out, data, THROUGHPUT_HEADER)


def sweep_batch(genome, reads, dev, out: Path, max_experiments: int,
                repetitions: int, failures: List[str], W: int = 64):
    """Batch-tile sweep: the analogue of the reference's thread sweep
    (profile.py:104-122) and GPU thread-block sweep (profile.py:177-248).
    Tiles larger than the dataset would measure padding and are dropped."""
    tiles = [1024, 2048, 4096, 8192, 16384, 24576,
             32768][: max(1, max_experiments)]
    tiles = [t for t in tiles if t <= max(1024, len(reads))]
    data: List = []
    for idx, tile in enumerate(tiles):
        print(f"[{datetime.now()}] sweep_batch {idx}/{len(tiles)}",
              file=sys.stderr)
        cfg = AlignConfig(W=W, K=W, O=W // 2 + 1, batch_tile=tile)
        for _ in range(repetitions):
            # one full tile per row (see _run_throughput_ladder)
            if not _run_throughput(genome, reads[:tile], cfg, data, dev):
                failures.append(f"batch {tile}")
        csv_write(out, data, THROUGHPUT_HEADER)


def _pairs(reads):
    """(pair_idx, read_idx, read, location) in read-major order."""
    k = 0
    for ri, read in enumerate(reads):
        for loc in read.locations:
            yield k, ri, read, loc
            k += 1


def accuracy_sweep(genome, reads, dev, out: Path, max_experiments: int,
                   cigar: bool, batch: int, failures: List[str],
                   max_W: int = 256):
    """Per-pair affine scores across W (profile.py:588-610): pair_idx,
    score(, cigar, read, reference) rows."""
    header = ["W", "O", "pair_idx", "score"] + (
        ["cigar", "read", "reference"] if cigar else [])
    gran = max(16, max_W // max(1, max_experiments))
    Ws = list(range(gran, max_W + 1, gran))
    data: List = []
    for idx, W in enumerate(Ws):
        print(f"[{datetime.now()}] accuracy_sweep {idx}/{len(Ws)}",
              file=sys.stderr)
        O = min(W // 2 + 1, W - 1)
        cfg = AlignConfig(W=W, K=W, O=O, batch_tile=batch)
        try:
            alns = api.align_reads(genome, reads, cfg, device=dev)
        except Exception as e:
            print(f"W={W} O={O}: config failed ({type(e).__name__}: {e})",
                  file=sys.stderr)
            failures.append(f"accuracy W={W}")
            continue
        for k, _, read, loc in _pairs(reads):
            a = alns[k]
            row = [W, O, k, affine_score(a.cigar, **SCORING)]
            if cigar:
                s = loc.start_in_reference
                row += [a.cigar, read.content,
                        genome.content[s : s + len(read.content) * 2]]
            data.append(row)
        csv_write(out, data, header)  # durable per config
    csv_write(out, data, header)


def _reachable(algorithms):
    """``algorithms`` without edlib where no edlib is reachable (said on
    stderr; not a failure)."""
    algs = list(algorithms)
    if "edlib" in algs and not edlib_available():
        print("edlib skipped: no edlib package or SCROOGE_EDLIB_SRC",
              file=sys.stderr)
        algs.remove("edlib")
    return algs


def sweep_baselines(genome, reads, dev, out: Path, batch: int,
                    failures: List[str], baseline_pairs: int = 32,
                    algorithms=None):
    """Throughput of every first-party algorithm on one dataset, the
    reference's cpu_baselines sweep (profile.py:250-313). The scalar-DP
    baselines run on the first ``baseline_pairs`` reads, GenASM on all of
    them; aligns/second is per pair either way. genasm_device runs on
    ``dev`` (kernel-only on the card, as every throughput row), genasm_xla
    is the plain engine on the CPU, at most 8192 pairs."""
    from ..cli.baseline_cli import align_with
    from .kernel_time import kernel_rate_samples, stage_mapped

    algorithms = _reachable(algorithms or [
        "genasm_device", "genasm_xla", "exact", "affine", "banded", "wfa",
        "wfa_lm", "gact", "sw", "edlib"])
    header = ["algorithm", "threads", "pairs", "aligns/second"]
    few = list(reads)[:baseline_pairs]
    data: List = []
    for alg in algorithms:
        subset = reads if alg.startswith("genasm_") and (
            alg != "genasm_pyref") else few
        b_alg = min(batch, 8192) if alg == "genasm_xla" else batch
        sub_alg = subset[:b_alg] if alg == "genasm_xla" else subset
        print(f"[{datetime.now()}] baselines {alg} ({len(sub_alg)} reads)",
              file=sys.stderr)
        try:
            if (alg == "genasm_device" and dev.type == "cuda"
                    and all(len(r.locations) == 1 for r in sub_alg)):
                cfg = AlignConfig(batch_tile=b_alg)
                samples = sorted(kernel_rate_samples(
                    stage_mapped(genome, sub_alg, cfg, dev)))
                data.append([alg, b_alg, min(len(sub_alg), b_alg),
                             samples[len(samples) // 2]])
                csv_write(out, data, header)
                continue
            _, aps = align_with(alg, genome, sub_alg, b_alg, dev)
        except Exception as e:
            print(f"{alg} failed ({type(e).__name__}: {e})", file=sys.stderr)
            failures.append(f"baseline {alg}")
            continue
        data.append([alg, b_alg, len(sub_alg), aps])
        csv_write(out, data, header)
    csv_write(out, data, header)


def groundtruth_accuracy(genome, reads, truth, dev, out: Path,
                         max_experiments: int, batch: int,
                         failures: List[str], max_W: int = 128, Os=None):
    """Fraction of ground-truth matched bases each CIGAR aligns
    identically, swept over W (and optionally O): the
    accuracy-vs-groundtruth evaluation of profile.py:446-645 /
    plot.py:2724-2952. CSV rows: W, O, pair_idx, score, correct_fraction."""
    from ..tools.cigar_tools import correctly_aligned_fraction

    header = ["W", "O", "pair_idx", "score", "correct_fraction"]
    gran = max(16, max_W // max(1, max_experiments))
    data: List = []
    for idx, W in enumerate(range(gran, max_W + 1, gran)):
        for O in Os or [min(W // 2 + 1, W - 1)]:
            if not 0 <= O < W:
                continue
            print(f"[{datetime.now()}] groundtruth {idx} W={W} O={O}",
                  file=sys.stderr)
            cfg = AlignConfig(W=W, K=W, O=O, batch_tile=batch)
            try:
                alns = api.align_reads(genome, reads, cfg, device=dev)
            except Exception as e:
                print(f"W={W} O={O}: config failed "
                      f"({type(e).__name__}: {e})", file=sys.stderr)
                failures.append(f"groundtruth W={W} O={O}")
                continue
            for k, ri, _, _ in _pairs(reads):
                ref_row, read_row = truth[ri]
                frac = correctly_aligned_fraction(alns[k].cigar, ref_row,
                                                  read_row)
                data.append([W, O, k, affine_score(alns[k].cigar, **SCORING),
                             round(frac, 6)])
            csv_write(out, data, header)  # durable
    csv_write(out, data, header)


def groundtruth_baselines(genome, reads, truth, dev, out: Path,
                          failures: List[str], algorithms=None):
    """Fraction of ground-truth matched bases each baseline aligns
    identically, the baseline rows of the reference's ground-truth
    comparison (plot.py:2724-2952). CSV rows: algorithm, pair_idx, score,
    correct_fraction."""
    from ..cli.baseline_cli import align_with
    from ..tools.cigar_tools import correctly_aligned_fraction

    data: List = []
    for alg in _reachable(algorithms or HOST_BASELINES):
        print(f"[{datetime.now()}] groundtruth_baselines {alg}",
              file=sys.stderr)
        try:
            alns, _ = align_with(alg, genome, reads, 2048, dev)
        except Exception as e:
            print(f"{alg} failed ({type(e).__name__}: {e})", file=sys.stderr)
            failures.append(f"groundtruth baseline {alg}")
            continue
        for k, ri, _, _ in _pairs(reads):
            ref_row, read_row = truth[ri]
            frac = correctly_aligned_fraction(alns[k].cigar, ref_row,
                                              read_row)
            data.append([alg, k, affine_score(alns[k].cigar, **SCORING),
                         round(frac, 6)])
    csv_write(out, data,
              ["algorithm", "pair_idx", "score", "correct_fraction"])


def baselines_accuracy(genome, reads, dev, out: Path, cigar: bool,
                       failures: List[str], algorithms=None):
    """Per-pair affine scores for every first-party baseline, the
    reference's accuracy_baselines (cpu_baseline.cpp:784-875)."""
    from ..cli.baseline_cli import align_with

    data: List = []
    for alg in _reachable(algorithms or HOST_BASELINES):
        print(f"[{datetime.now()}] baselines_accuracy {alg}",
              file=sys.stderr)
        try:
            alns, _ = align_with(alg, genome, reads, 2048, dev)
        except Exception as e:
            print(f"{alg} failed ({type(e).__name__}: {e})", file=sys.stderr)
            failures.append(f"accuracy baseline {alg}")
            continue
        for k, _, _, _ in _pairs(reads):
            a = alns[k]
            data.append([alg, k, affine_score(a.cigar, **SCORING)]
                        + ([a.cigar] if cigar else []))
    header = ["algorithm", "pair_idx", "score"] + (["cigar"] if cigar else [])
    csv_write(out, data, header)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Sweep GenASM throughput or accuracy over configs on a "
                    "torch device")
    p.add_argument("target",
                   choices=["device", "accuracy", "groundtruth", "baselines"])
    p.add_argument("dataset", type=str,
                   help="datasets_dir subdirectory or "
                        "'simulated[:N[:len[:decoys[:accuracy]]]]' "
                        "(decoys>0 = the chained candidate model: extra "
                        "wrong candidates per read)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where GenASM runs: the CUDA kernels, or the plain "
                        "torch engine on the CPU (no fallback)")
    p.add_argument("--datasets_dir", type=Path, default=Path("datasets"))
    p.add_argument("--profile_dir", type=Path, default=Path("profile"))
    p.add_argument("--max_experiments", type=int, default=8)
    p.add_argument("--repetitions", type=int, default=1)
    p.add_argument("--override_W", type=int, default=None)
    p.add_argument("--max_W", type=int, default=256)
    p.add_argument("--batch_tile", type=int, default=2048)
    p.add_argument("--baseline_pairs", type=int, default=32)
    p.add_argument("--cigar", action="store_true")
    p.add_argument("--families", type=str, default=None,
                   help="comma subset of the device sweep families to run "
                        "(WO,O,batch); default all")
    p.add_argument("--Os", type=str, default=None,
                   help="comma list of overlaps for the groundtruth "
                        "target (the O axis of the reference's W/O "
                        "accuracy trade-off, profile.py:588-645); "
                        "combine with --max_W W --max_experiments 1 for a "
                        "pure O sweep")
    args = p.parse_args(argv)

    dev = api.resolve_device(args.device)  # raises without a card
    if args.target == "groundtruth":
        genome, reads, truth = _load(args.dataset, args.datasets_dir,
                                     with_truth=True)
    else:
        genome, reads = _load(args.dataset, args.datasets_dir)
    name = args.dataset.replace(":", "_")
    out = args.profile_dir
    W = args.override_W or 64
    failures: List[str] = []

    if args.target == "groundtruth":
        os_list = ([int(x) for x in args.Os.split(",") if x]
                   if args.Os else None)
        suffix = "_O" if os_list else ""
        groundtruth_accuracy(genome, reads, truth, dev,
                             out / f"{name}_groundtruth_accuracy{suffix}.csv",
                             args.max_experiments, args.batch_tile, failures,
                             args.max_W, Os=os_list)
        # the baselines have no W/O dependence: skip them on --Os
        # O-sweeps (the W-sweep run already recorded them) and when
        # --baseline_pairs=0
        few = list(reads)[: args.baseline_pairs]
        if few and not os_list:
            groundtruth_baselines(genome, few, truth[: len(few)], dev,
                                  out / f"{name}_groundtruth_baselines.csv",
                                  failures)
    elif args.target == "baselines":
        sweep_baselines(genome, reads, dev, out / f"{name}_baselines.csv",
                        args.batch_tile, failures, args.baseline_pairs)
    elif args.target == "device":
        budget = run_buffer_budget(dev)
        families = {
            "WO": lambda: sweep_wo(genome, reads, dev,
                                   out / f"{name}_device_sweep_WO.csv",
                                   args.max_experiments, args.repetitions,
                                   args.batch_tile, budget, failures,
                                   args.max_W),
            "O": lambda: sweep_o(genome, reads, dev,
                                 out / f"{name}_device_sweep_O.csv",
                                 args.max_experiments, args.repetitions,
                                 args.batch_tile, budget, failures, W),
            "batch": lambda: sweep_batch(genome, reads, dev,
                                         out / f"{name}_device_sweep_batch"
                                               ".csv",
                                         args.max_experiments,
                                         args.repetitions, failures, W),
        }
        wanted = (args.families.split(",") if args.families
                  else list(families))
        unknown = [f for f in wanted if f not in families]
        if unknown:
            p.error(f"unknown families {unknown}; the port has "
                    f"{sorted(families)}")
        for fname in wanted:
            try:
                families[fname]()
            except Exception as e:  # the next family still runs
                print(f"sweep family {fname} failed "
                      f"({type(e).__name__}: {e})", file=sys.stderr)
                failures.append(f"family {fname}")
    else:
        cig = "_cigar" if args.cigar else ""
        accuracy_sweep(genome, reads, dev,
                       out / f"{name}_accuracy_sweep_wo{cig}.csv",
                       args.max_experiments, args.cigar, args.batch_tile,
                       failures, args.max_W)
        baselines_accuracy(genome, reads, dev,
                           out / f"{name}_baselines_accuracy{cig}.csv",
                           args.cigar, failures)
    if failures:
        print(f"{len(failures)} failed: {', '.join(failures)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
