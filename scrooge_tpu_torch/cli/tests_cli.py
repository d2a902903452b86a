"""`tests` binary analogue: unit tests and the performance test from the CLI.

The port's own copy of ``scrooge_tpu/cli/tests_cli.py``, which mirrors the
reference's tests.cu (flags: tests.cu:726-765; unit tests: tests.cu:782-816;
performance test: tests.cu:335-487). ``--device`` picks the torch device,
``cuda`` by default, which aligns on every visible card (a mesh, as the
JAX CLI takes every local device); there is no fallback, so without a
card the run raises unless ``--device=cpu`` is given:

  python -m scrooge_tpu_torch.cli.tests_cli --unit_tests [--device=cpu]
  python -m scrooge_tpu_torch.cli.tests_cli --reference=... --reads=... --seeds=...
  python -m scrooge_tpu_torch.cli.tests_cli --cpu_performance_test ...  (= --device=cpu)

Output formats are API: profiling tools scrape the "ran at N
aligns/second" lines.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, NamedTuple

import torch

from .. import api
from ..cigar import CigarError, validate_cigar
from ..config import AlignConfig
from ..datamodel import Alignment, CandidateLocation, Genome, Read
from . import options as opt

HELP_TEXT = """\
python -m scrooge_tpu_torch.cli.tests_cli [options]
Options:
--reference=[path to reference FASTA] -- override default reference data for performance test
--reads=[path to reads FASTQ]         -- override default reads data for performance test
--seeds=[path to MAF or PAF]          -- override default seeds data for performance test
--device=[cuda|cpu]                   -- torch device of the engine (default: cuda; no fallback)
--device_info_only                    -- only print device info
--verbose                             -- print progress to stderr. Otherwise, only test results are printed
--unit_tests                          -- run unit tests (default: disabled)
--cpu_performance_test                -- alias of --device=cpu, the JAX CLI's name for its portable-engine performance test
--profile=[trace dir]                 -- write a torch.profiler trace (trace.json) of the performance run
--simulated=[N[,LEN]]                 -- use a built-in simulated dataset instead of files
--read_length_cap=[N]                 -- truncate every read to N characters (tests.cu:361-365)
--dataset_inflation=[N]               -- duplicate the read set N times (tests.cu:367-373)
--help                                -- displays this information
"""

ALLOWED = ["--reference", "--reads", "--seeds", "--device",
           "--device_info_only", "--verbose", "--unit_tests",
           "--cpu_performance_test", "--profile", "--simulated",
           "--read_length_cap", "--dataset_inflation", "--help"]

# Golden cases from the reference kernel unit tests (tests.cu:183-196):
# 9 handcrafted reads against a 16bp reference, expected edit distances
# {8, 0, 3, 8, 12, 6, 8, 0, 48}, incl. empty/oversized/len-64 boundary.
GOLDEN_REFERENCE = "AAAACCCCGGGGTTTT"
GOLDEN_READS = [
    ("test_read_4d12m4i", "CCCCGGGGTTTTAAAA"),
    ("test_read_16m", "AAAACCCCGGGGTTTT"),
    ("test_read_3d7m", "ACCCCGG"),
    ("test_read_4m4d4m4i4m", "AAAAGGGGAAAATTTT"),
    ("test_read_12s4m", "AAAAAAAAAAAAAAAA"),
    ("test_read_1m1s1i3m1s2m3i", "ATTAACGCCTTT"),
    ("test_read_oversized", "TTTTAAAACCCCGGGGTTTTAAAA"),
    ("test_read_empty", ""),
    ("test_read_len64",
     "TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTAAAACCCCGGGGTTTTAAAA"),
]
GOLDEN_DISTANCES = [8, 0, 3, 8, 12, 6, 8, 0, 48]

DEFAULT_DIR = "datasets/default"


class PerformanceRun(NamedTuple):
    """What performance_test aligned: the reads as aligned (filtered,
    capped, inflated and sorted), one alignment per (read, location) in
    read-major order, the call's AlignStats, and host nanoseconds per
    stage: ``reference`` (FASTA parse), ``reads_seeds`` (FASTQ and seed
    parse and the join), ``shape`` (filter, cap, inflate, sort),
    ``align`` (the align_reads call), ``check`` (every CIGAR validated)."""

    reads: List[Read]
    alignments: List[Alignment]
    stats: api.AlignStats
    stage_ns: Dict[str, int]


def print_device_info(device) -> None:
    """One line per device of ``device``'s type."""
    if torch.device(device).type == "cuda":
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        platform = "gpu"
    else:
        names, platform = ["cpu"], "cpu"
    print(f"{len(names)} visible device(s):")
    for i, name in enumerate(names):
        print(f'idx={i} name="{name}" platform={platform}')
    print()


def _golden_genome_reads():
    genome = Genome(content=GOLDEN_REFERENCE)
    loc = CandidateLocation(start_in_reference=0, start_in_chromosome=0,
                            strand=True, chromosome="")
    reads = [Read(description=d, content=c, locations=[loc])
             for d, c in GOLDEN_READS]
    return genome, reads


def _engine_correctness_test(name: str, cfg: AlignConfig, device) -> bool:
    genome, reads = _golden_genome_reads()
    alignments = api.align_all(genome, reads, config=cfg, device=device)
    if len(alignments) != len(GOLDEN_DISTANCES):
        print(f"FAILED {name}: align_all() produced wrong number of "
              "alignments")
        return False
    success = True
    for i, (a, want) in enumerate(zip(alignments, GOLDEN_DISTANCES)):
        if a.edit_distance != want:
            print(f"FAILED {name}: align_all() produced distance "
                  f"{a.edit_distance} instead of {want} for read "
                  f'"{reads[i].description}"')
            success = False
        try:
            validate_cigar(a.cigar, a.edit_distance, GOLDEN_REFERENCE,
                           reads[i].content, 0)
        except CigarError as e:
            print(f"FAILED {name}: {e} for read \"{reads[i].description}\"")
            success = False
    if success:
        print(f"PASSED {name}")
    return success


def bitvector_tests(device) -> bool:
    """The engine's multiword bitvector primitives (``engine._Words.shl1``,
    ``engine.ones_shifted``, ``engine._Words.bit``) on an awkward 65-bit
    width, two 64-bit words (bitvector_test.cu:5-130 analogue)."""
    import numpy as np

    from ..ops import engine

    W = 65
    words = engine._Words(W, device)
    mask64 = (1 << engine.WORD) - 1

    def to_tensor(val):
        return words.const([engine._signed((val >> (engine.WORD * k))
                                           & mask64)
                            for k in range(words.nw)])

    def to_int(t):
        return sum((int(w) & mask64) << (engine.WORD * k)
                   for k, w in enumerate(t.reshape(-1).tolist()))

    ok = True
    rng = np.random.default_rng(0)
    for _ in range(50):
        val = int(rng.integers(0, 2)) and rng.integers(0, 1 << 63)
        val = int(val) | (int(rng.integers(0, 2)) << 64)
        v = to_tensor(val)
        got = to_int(words.shl1(v))
        want = (val << 1) & ((1 << W) - 1)
        if got != want:
            print(f"FAILED bitvector shl1: {val:#x} -> {got:#x}, "
                  f"want {want:#x}")
            ok = False
        sh = int(rng.integers(0, W + 2))
        got = to_int(words.const(engine.ones_shifted(W, sh)))
        want = (((1 << W) - 1) << sh) & ((1 << W) - 1)
        if got != want:
            print(f"FAILED bitvector ones_shifted({sh}): {got:#x}, "
                  f"want {want:#x}")
            ok = False
        bit = int(rng.integers(0, W))
        got = int(engine._Words.bit(
            v, torch.full((1,), bit, dtype=torch.int64, device=device))[0])
        if got != (val >> bit) & 1:
            print(f"FAILED bitvector bit({bit}) on {val:#x}")
            ok = False
    if ok:
        print("PASSED bitvector_tests")
    return ok


def packing_correctness_test(device) -> bool:
    """2-bit packing (``ops.pack.pack_2bit``) against a scalar model
    (tests.cu:582-647 analogue, incl. empty and non-multiple-of-word
    lengths)."""
    import numpy as np

    from ..ops.pack import pack_2bit

    ok = True
    rng = np.random.default_rng(1)
    for length in [0, 1, 3, 15, 16, 17, 31, 33, 100]:
        codes = rng.integers(0, 4, (1, length), dtype=np.uint8)
        got = pack_2bit(torch.from_numpy(codes).to(device)).cpu().numpy()
        got = got.view(np.uint32)[0]
        want = np.zeros(-(-length // 16), np.uint32)
        for k in range(length):
            want[k // 16] |= np.uint32(int(codes[0, k]) << (2 * (k % 16)))
        if not np.array_equal(got, want):
            print(f"FAILED packing_correctness_test at length {length}")
            ok = False
    if ok:
        print("PASSED packing_correctness_test")
    return ok


def library_interface_correctness_test(device) -> bool:
    """pyref and the engine on ``device`` must give identical alignments
    over both interfaces (tests.cu:273-333 analogue; compares distances
    and CIGARs)."""
    import random

    rng = random.Random(7)
    texts, queries = [], []
    for _ in range(8):
        t = "".join(rng.choice("ACGT") for _ in range(100))
        q = "".join(c for c in t if rng.random() > 0.05)
        texts.append(t)
        queries.append(q or "A")

    results = {}
    for backend in ("pyref", "auto"):
        cfg = AlignConfig(backend=backend, batch_tile=128)
        pair = api.align_pairs(texts, queries, cfg, device=device)
        mapped = []
        for t, q in zip(texts, queries):
            genome = Genome(content=t)
            read = Read(description="r", content=q,
                        locations=[CandidateLocation(start_in_reference=0)])
            mapped.append(api.align_reads(genome, [read], cfg,
                                          device=device)[0])
        results[backend] = (pair, mapped)

    ok = True
    base_pair, _ = results["pyref"]
    for backend, (pair, mapped) in results.items():
        for i in range(len(texts)):
            for got in (pair[i], mapped[i]):
                if got.edit_distance != base_pair[i].edit_distance:
                    print(f"FAILED library_interface_correctness_test: "
                          f"distances disagree ({backend}, pair {i})")
                    ok = False
                if got.cigar != base_pair[i].cigar:
                    print(f"FAILED library_interface_correctness_test: "
                          f"cigars disagree ({backend}, pair {i})")
                    ok = False
    if ok:
        print("PASSED library_interface_correctness_test")
    return ok


def unit_tests(device) -> bool:
    """The reference's unit tests, in its order; prints one PASSED or
    FAILED line each. ``xla_algorithm_correctness_test`` keeps its name
    and runs the plain torch engine on the CPU (the JAX package's portable
    engine's role); ``device_algorithm_correctness_test`` runs the engine
    on ``device``."""
    print_device_info(device)
    ok = bitvector_tests(device)
    ok &= packing_correctness_test(device)
    ok &= _engine_correctness_test("xla_algorithm_correctness_test",
                                   AlignConfig(batch_tile=128), "cpu")
    ok &= _engine_correctness_test("device_algorithm_correctness_test",
                                   AlignConfig(batch_tile=128), device)
    ok &= library_interface_correctness_test(device)
    return ok


def load_simulated(spec: str):
    """(genome, reads) of ``--simulated=N[,LEN]``: N reads (256) of LEN bp
    (2,000) from a 500 kbp genome, seed 13."""
    from ..utils.simulate import simulate_dataset

    parts = (spec or "").split(",")
    num = int(parts[0]) if parts[0] else 256
    rlen = int(parts[1]) if len(parts) > 1 else 2000
    ds = simulate_dataset(genome_len=500_000, num_reads=num, read_len=rlen,
                          accuracy=0.95, seed=13)
    return ds.genome, ds.reads


def performance_test(reference_file: str, reads_file: str, seeds_file: str,
                     cfg: AlignConfig, device, profile_dir: str = None,
                     simulated: str = None, read_length_cap: int = -1,
                     dataset_inflation: int = 1) -> PerformanceRun:
    """Performance run over a dataset directory's files (tests.cu:335-487
    analogue): filter reverse strands, apply the read length cap and the
    inflation, sort by length descending, align on ``device``, validate
    every CIGAR, print the three timing lines ("GPU kernel" on a CUDA
    device, "CPU kernel" on the CPU)."""
    from .. import io as sio

    log = api.enabled_algorithm_log

    def vlog(msg):
        if log:
            print(msg, file=sys.stderr)

    stage_ns = {}
    vlog("Starting performance test...")
    t0 = time.perf_counter_ns()
    if simulated is not None:
        genome, reads = load_simulated(simulated)
        stage_ns["reference"] = time.perf_counter_ns() - t0
        t0 = time.perf_counter_ns()
    else:
        if (reference_file == f"{DEFAULT_DIR}/reference.fasta"
                and not os.path.exists(reference_file)):
            # the default invocation with no downloaded data: write a
            # simulated default dataset once (reference.fasta, reads.fastq
            # and a ground-truth candidates.maf) so the binary analogue
            # runs as shipped
            from ..utils.simulate import simulate_dataset, write_dataset

            print(f"default dataset missing; simulating one under "
                  f"{DEFAULT_DIR} (PBSIM2-style 1024x10kbp reads)",
                  file=sys.stderr)
            write_dataset(simulate_dataset(num_reads=1024, with_truth=True),
                          DEFAULT_DIR)
            t0 = time.perf_counter_ns()
        vlog("Reading reference sequence...")
        genome = sio.read_genome(reference_file)
        stage_ns["reference"] = time.perf_counter_ns() - t0
        vlog("Reading reads files...")
        t0 = time.perf_counter_ns()
        reads = sio.read_fastq_and_seed_locations(genome, reads_file,
                                                  seeds_file)
    stage_ns["reads_seeds"] = time.perf_counter_ns() - t0

    t0 = time.perf_counter_ns()
    vlog("Filtering reads...")
    for read in reads:
        read.locations = [l for l in read.locations if l.strand]

    # workload-shaping knobs (tests.cu:361-373): truncate reads, then
    # duplicate the read set to inflate the dataset
    if read_length_cap >= 0:
        for read in reads:
            read.content = read.content[:read_length_cap]
    if dataset_inflation > 1:
        base = list(reads)
        for _ in range(dataset_inflation - 1):
            reads.extend(base)

    vlog("Sorting reads...")
    reads.sort(key=lambda r: -len(r.content))
    stage_ns["shape"] = time.perf_counter_ns() - t0

    vlog("Running alignment algorithm...")
    if profile_dir:
        # a host and device trace for external analysis (the reference
        # relies on nvcc -lineinfo and external profilers)
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function("align_reads"):
                t0 = time.perf_counter_ns()
                alignments, stats = api.align_reads(
                    genome, reads, cfg, return_stats=True, device=device)
                end_to_end_ns = time.perf_counter_ns() - t0
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        vlog(f"profiler trace written to {profile_dir}")
    else:
        t0 = time.perf_counter_ns()
        alignments, stats = api.align_reads(genome, reads, cfg,
                                            return_stats=True, device=device)
        end_to_end_ns = time.perf_counter_ns() - t0
    stage_ns["align"] = end_to_end_ns

    vlog("Sanity checking alignments...")
    t0 = time.perf_counter_ns()
    pair_idx = 0
    for read in reads:
        for loc in read.locations:
            a = alignments[pair_idx]
            try:
                validate_cigar(a.cigar, a.edit_distance, genome.content,
                               read.content, loc.start_in_reference)
            except CigarError:
                print("FAILED sanity check in algorithm_performance_test "
                      f"for alignment {pair_idx}")
            pair_idx += 1
    stage_ns["check"] = time.perf_counter_ns() - t0
    vlog("Done")

    n = max(len(alignments), 1)
    device_name = "GPU" if torch.device(device).type == "cuda" else "CPU"
    print(f"align_all() took {end_to_end_ns // 1_000_000}ms (data "
          "transfers, conversion, kernel and post-processing)")
    print(f"{device_name} kernel took {stats.core_ns // 1_000_000}ms")
    print(f"{device_name} kernel ran at "
          f"{n * 1_000_000_000 // max(stats.core_ns, 1)} aligns/second")
    return PerformanceRun(reads, alignments, stats, stage_ns)


def main(argv: List[str] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = opt.scan_args(argv)

    reference_file = f"{DEFAULT_DIR}/reference.fasta"
    reads_file = f"{DEFAULT_DIR}/reads.fastq"
    seeds_file = f"{DEFAULT_DIR}/candidates.maf"

    bad = not opt.check_options(args, ALLOWED)
    device_info_only = opt.get_flag(args, "--device_info_only")[0]
    verbose = opt.get_flag(args, "--verbose")[0]
    unit = opt.get_flag(args, "--unit_tests")[0]
    cpu_perf = opt.get_flag(args, "--cpu_performance_test")[0]
    for flag in (device_info_only, verbose, unit, cpu_perf):
        bad |= flag == opt.Opt.INVALID
    st, reference_file = opt.get_value(args, "--reference", reference_file)
    bad |= st == opt.Opt.INVALID
    st, reads_file = opt.get_value(args, "--reads", reads_file)
    bad |= st == opt.Opt.INVALID
    st, seeds_file = opt.get_value(args, "--seeds", seeds_file)
    bad |= st == opt.Opt.INVALID
    st, device_s = opt.get_value(args, "--device", "cuda")
    bad |= st == opt.Opt.INVALID or device_s not in ("cuda", "cpu")
    st, profile_dir = opt.get_value(args, "--profile", None)
    bad |= st == opt.Opt.INVALID
    st, simulated = opt.get_value(args, "--simulated")
    simulated = simulated if st == opt.Opt.VALUE else None
    bad |= st == opt.Opt.INVALID
    st, cap_s = opt.get_value(args, "--read_length_cap", "-1")
    bad |= st == opt.Opt.INVALID
    st, infl_s = opt.get_value(args, "--dataset_inflation", "1")
    bad |= st == opt.Opt.INVALID
    try:
        read_length_cap, dataset_inflation = int(cap_s), int(infl_s)
    except ValueError:
        bad = True
        read_length_cap, dataset_inflation = -1, 1
    bad |= "--help" in args

    if bad:
        print(HELP_TEXT, end="")
        return 0

    # "cuda" is every visible card, as the JAX CLI takes every local
    # device; it raises without one unless the CPU is asked for: no
    # fallback
    if cpu_perf == opt.Opt.EXISTS:
        device_s = "cpu"
    api.resolve_mesh(device_s)
    device = device_s

    if device_info_only == opt.Opt.EXISTS:
        print_device_info(device)
        return 0

    api.enabled_algorithm_log = verbose == opt.Opt.EXISTS

    if unit == opt.Opt.EXISTS:
        return 0 if unit_tests(device) else 1

    print_device_info(device)
    performance_test(reference_file, reads_file, seeds_file, AlignConfig(),
                     device, profile_dir, simulated, read_length_cap,
                     dataset_inflation)
    return 0


if __name__ == "__main__":
    sys.exit(main())
