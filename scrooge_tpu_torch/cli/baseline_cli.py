"""`cpu_baseline` binary analogue: benchmark and accuracy comparison runs.

The port's own copy of ``scrooge_tpu/cli/baseline_cli.py``, which mirrors
the reference's cpu_baseline.cpp (flags: :914-926; benchmark_baselines
:727-782; accuracy_baselines :784-875). The algorithm names stay those
of the JAX package, so scrapers keep working; the GenASM ones map onto
the port's engines:

  genasm_device  — the CUDA kernel on --device, every visible card for
                   cuda (the plain torch engine with --device=cpu)
  genasm_xla     — the plain torch engine on the CPU, the same as
                   genasm_device --device=cpu
  genasm_pyref   — the port's scalar oracle
  exact          — exact semiglobal edit-distance DP (the edlib role)
  affine         — exact affine-gap Gotoh DP (the ksw2 role)
  banded         — adaptive band-doubling aligner (the WFA-adaptive role)
  wfa            — first-party exact wavefront aligner, global on a
                   read-length text window (the wfa_exact role,
                   cpu_baseline.cpp:487-549)
  wfa_lm         — low-memory penalty-only wavefront pass (the wfa_lm
                   role, cpu_baseline.cpp:387-438; perf-only, no CIGAR)
  gact           — GACT-tiling aligner (the Darwin custom-GACT role)
  sw             — exact local Smith-Waterman-Gotoh (the CUDASW++ role;
                   local segment CIGAR, scores are local-alignment scores)
  edlib          — the third-party edlib, when edlib_available()

The baselines other than genasm_* run numpy on the host, as in the
reference. Output formats are API (scraped by sweep tooling):
  "<algorithm>: <N.NN> aligns/second"
  "pair_idx=<i> score=<s>[ cigar=<c> read=<r> reference=<ref>]"
"""

from __future__ import annotations

import sys
import time
from typing import List

from .. import api
from ..baselines import (affine_semiglobal, banded_semiglobal,
                         edlib_semiglobal_cigar, exact_semiglobal,
                         gact_tiled, local_affine)
from ..cigar import affine_score, edits_in_cigar
from ..config import AlignConfig
from ..datamodel import Alignment
from ..wfa import wfa_distance, wfa_global
from . import options as opt
from .tests_cli import DEFAULT_DIR, load_simulated

HELP_TEXT = """\
python -m scrooge_tpu_torch.cli.baseline_cli [options]
Options:
--reference=[path to reference FASTA] -- override default reference data for performance test
--reads=[path to reads FASTQ]         -- override default reads data for performance test
--seeds=[path to MAF or PAF]          -- override default seeds data for performance test
--device=[cuda|cpu]                   -- torch device of genasm_device (default: cuda; no fallback)
--threads=[TILE[,MORE_TILES]]         -- run benchmarks with the given list of batch tiles (lanes) default:2048
--algorithms=[ALGORITHM[,MORE ALGORITHMS]] -- run only the specified algorithms, supported are: genasm_device (the CUDA kernel on --device), genasm_xla (the plain torch engine on the CPU, the same as genasm_device --device=cpu), genasm_pyref (the scalar oracle), exact, affine, banded, wfa, wfa_lm, gact, sw, edlib
--scoring=[MAT],[SUB],[GAPO],[GAPE]   -- set affine gap model scoring function, all values should be positive default:2,4,4,2
--simulated=[N[,LEN]]                 -- use a built-in simulated dataset instead of files
--verbose                             -- print progress to stderr. Otherwise, only benchmark results are printed
--accuracy                            -- print alignment score for each pair (do not run performance experiments)
--cigar                               -- print cigar string for each pair (requires --accuracy)
--help                                -- displays this information
"""

ALLOWED = ["--reference", "--reads", "--seeds", "--device", "--threads",
           "--algorithms", "--scoring", "--simulated", "--verbose",
           "--accuracy", "--cigar", "--help"]
ALL_ALGS = ["genasm_device", "genasm_xla", "genasm_pyref", "exact",
            "affine", "banded", "wfa", "wfa_lm", "gact", "sw", "edlib"]
HOST_ALGS = ALL_ALGS[3:]


def _load(args):
    st, sim = opt.get_value(args, "--simulated")
    if st == opt.Opt.VALUE:
        return load_simulated(sim)
    from .. import io as sio

    _, ref = opt.get_value(args, "--reference",
                           f"{DEFAULT_DIR}/reference.fasta")
    _, rds = opt.get_value(args, "--reads", f"{DEFAULT_DIR}/reads.fastq")
    _, sds = opt.get_value(args, "--seeds", f"{DEFAULT_DIR}/candidates.maf")
    genome = sio.read_genome(ref)
    return genome, sio.read_fastq_and_seed_locations(genome, rds, sds)


def _align_host(alg: str, text: str, query: str):
    """(edit distance, CIGAR) of one host baseline."""
    if alg == "exact":
        return exact_semiglobal(text, query)
    if alg == "banded":
        return banded_semiglobal(text, query)
    if alg == "edlib":
        return edlib_semiglobal_cigar(text, query)
    if alg == "wfa_lm":
        return wfa_distance(text, query, semiglobal=False), ""
    if alg == "wfa":
        cg = wfa_global(text, query)[1]
    elif alg == "sw":
        cg = local_affine(text, query)[1]
    elif alg == "gact":
        cg = gact_tiled(text, query)
    else:
        cg = affine_semiglobal(text, query)[1]
    return edits_in_cigar(cg), cg


def align_with(alg: str, genome, reads, tile: int, device):
    """(alignments in read-major order, aligns/second) of one algorithm."""
    if alg in HOST_ALGS:
        out: List[Alignment] = []
        t0 = time.perf_counter_ns()
        for read in reads:
            for loc in read.locations:
                start = loc.start_in_reference
                # gact's per-tile DP and wfa's global alignment both pay
                # for unconsumed text: the reference passes a text window of
                # exactly read length (cpu_baseline.cpp:466,516-517)
                span = (len(read.content) if alg in ("gact", "wfa",
                                                     "wfa_lm")
                        else 2 * len(read.content) + 64)
                ed, cg = _align_host(alg, genome.content[start : start + span],
                                     read.content)
                out.append(Alignment(cigar=cg, edit_distance=ed))
        core_ns = time.perf_counter_ns() - t0
        return out, max(len(out), 1) * 1e9 / max(core_ns, 1)
    backend = "pyref" if alg == "genasm_pyref" else "auto"
    dev = "cpu" if alg == "genasm_xla" else device
    cfg = AlignConfig(backend=backend, batch_tile=tile)
    if backend == "pyref":
        t0 = time.perf_counter_ns()
        alns = api.align_reads(genome, reads, cfg, device=dev)
        core_ns = time.perf_counter_ns() - t0
        return alns, len(alns) * 1e9 / max(core_ns, 1)
    alns, stats = api.align_reads(genome, reads, cfg, return_stats=True,
                                  device=dev)
    return alns, stats.aligns_per_second


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = opt.scan_args(argv)

    bad = not opt.check_options(args, ALLOWED)
    verbose = opt.get_flag(args, "--verbose")[0] == opt.Opt.EXISTS
    accuracy = opt.get_flag(args, "--accuracy")[0] == opt.Opt.EXISTS
    print_cigar = opt.get_flag(args, "--cigar")[0] == opt.Opt.EXISTS
    st, device_s = opt.get_value(args, "--device", "cuda")
    bad |= st == opt.Opt.INVALID or device_s not in ("cuda", "cpu")
    st, threads_s = opt.get_value(args, "--threads", "2048")
    bad |= st == opt.Opt.INVALID
    st, algs_s = opt.get_value(args, "--algorithms", ",".join(ALL_ALGS))
    bad |= st == opt.Opt.INVALID
    st, scoring_s = opt.get_value(args, "--scoring", "2,4,4,2")
    bad |= st == opt.Opt.INVALID
    bad |= "--help" in args
    if bad:
        print(HELP_TEXT, end="")
        return 0

    # "cuda" is every visible card, as the JAX CLI takes every local
    # device; it raises without one unless --device=cpu: no fallback
    api.resolve_mesh(device_s)
    device = device_s
    tiles = [int(x) for x in threads_s.split(",") if x]
    algorithms = [a for a in algs_s.split(",") if a]
    unknown = [a for a in algorithms if a not in ALL_ALGS]
    if unknown:
        print(f"unknown algorithms: {unknown}", file=sys.stderr)
        return 1
    mat, sub, gapo, gape = (int(x) for x in scoring_s.split(","))
    api.enabled_algorithm_log = verbose

    genome, reads = _load(args)
    if verbose:
        print(f"{len(reads)} reads", file=sys.stderr)

    if accuracy and "wfa_lm" in algorithms:
        # wfa_lm is penalty-only (no CIGAR): a made-up score=0 row would
        # be indistinguishable from a real score in the scraped format
        print("wfa_lm skipped in --accuracy mode (no CIGAR)",
              file=sys.stderr)
        algorithms = [a for a in algorithms if a != "wfa_lm"]

    for tile in tiles:
        print(f"{tile} threads")
        for alg in algorithms:
            alns, aps = align_with(alg, genome, reads, tile, device)
            if accuracy:
                pair_idx = 0
                for read in reads:
                    for loc in read.locations:
                        al = alns[pair_idx]
                        score = affine_score(al.cigar, mat, sub, gapo, gape)
                        line = f"pair_idx={pair_idx} score={score}"
                        if print_cigar:
                            start = loc.start_in_reference
                            ref_sub = genome.content[
                                start : start + len(read.content)]
                            line += (f" cigar={al.cigar} read={read.content}"
                                     f" reference={ref_sub}")
                        print(line)
                        pair_idx += 1
            else:
                print(f"{alg}: {aps:.2f} aligns/second")
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
