"""Smoke run of the torch port on one NVIDIA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py

Phases, one line each:
  1. toolchain: torch, CUDA, nvcc, triton, and the card as nvidia-smi
     reports it (its own line);
  2. build: compile the four kernel sources from csrc/ with nvcc, one
     process each, started together; registers and spills of every
     instantiation, and no kernel may spill;
  3. kernel against plain: the window kernel and the plain torch engine on
     the same device tensors, 512 pairs of ~1 kbp at W/K/O 64/64/33,
     32/32/17, 96/96/49, 128/128/65, 128/128/2 (two traceback mask words,
     every R word stored), 192/192/97 and 256/256/129 (W <= 64 on the
     one-word kernel genasm_windows1.cu, two to four words on
     genasm_windows.cu); then 512 unrelated pairs of 1 kbp at 64/64/33
     and 128/128/65 (a quarter of the texts run out: rows up to K and the
     row pair that computes row K+1) and at 64/16/33 and 128/16/65
     (FAIL_TB lanes); then the main path's own tile (16384 reads of 10 kbp
     at 64/64/33); every output must be identical;
  4. main path: align_reads on the bench workload (simulate_dataset(
     1 Mbp genome, 16384 reads x 10 kbp, 95 % accuracy, seed 7), W=64
     K=64 O=33, one tile of 16384), strings then packed; the one-word
     kernel's launch count must grow and the multiword kernel must not
     launch, both outputs must agree, sampled pairs must equal pyref and
     carry valid CIGARs;
  5. kernel-only time of the same tile, CUDA events, 3 x 3 calls;
  6. the README's quick-start pair;
  7. wide path: the same tile at W=128 K=128 O=65 (two words), kernel
     against plain, then align_reads checked as in phase 4, and its
     kernel-only time; then align_reads at 192/192/97 and 256/256/129 on
     512 reads of 2 kbp, each held against plain and pyref;
  8. fill lab: each variant of the fill-only kernel against its plain
     version at 2048 lanes, 2 windows, on the (m, n) cases of
     kernel_lab.MN_CASES (the lab's own inputs among them), and at 16384
     lanes, 1 window, on the lab's inputs (per-lane wed, the sum and, in full, the rows of
     R both must store, identical), the plain version's time at 64
     windows on the lab's inputs at both widths, then the lab entry
     point's timing at 64 windows for 2048 and 16384 lanes, each beside
     its bound;
  9. file path, the CLIs of scrooge_tpu_torch.cli on the card:
     tests_cli --unit_tests (the one-word kernel must launch); phase 4's
     bench dataset written to a temporary directory as reference.fasta,
     reads.fastq and candidates.maf, each parsed alone and timed, then run
     through tests_cli's performance_test (parse, seed join, align_reads
     with the CLI's
     default config, every CIGAR checked): each of the 16384 alignments
     must equal phase 4's strings for the same (read, location), the
     one-word kernel must launch and the multiword one must not; the same
     files again through tests_cli --profile, whose torch.profiler trace
     must hold the window kernel and gives the device's busy and idle
     share of the align_reads call; then baseline_cli --accuracy --cigar
     --algorithms=genasm_device,exact on the first 64 reads of phase 7's
     512 x 2 kbp set written to files, whose genasm_device lines must
     equal align_reads on the card for the same pairs;
 10. windows wider than 256 (genasm_windows_wide.cu, a group of G threads
     a pair): the kernel against plain on 256 pairs of ~2 kbp at W/K/O
     257/257/129 (one bit in the top word), 320/320/161, 512/512/257 and
     512/512/0 (G = 8) and on 64 pairs at 1024/1024/513 (G = 16) and
     2048/2048/1025 (G = 32); on 256 unrelated pairs at 512/64/257, which
     must give FAIL_TB lanes; one tile split into several launches by a
     small scratch budget against one launch; then the slice's path,
     align_reads at W=512 K=512 O=257 on the first 1024 reads of phase
     4's dataset (one tile), strings then packed, checked as in phase 4
     with the wide kernel's launch count, the kernel against plain on
     that tile and its kernel-only time; then the sweep entry point on the
     card, ``device simulated:1024:10000 --families WO --max_W 512
     --max_experiments 2`` into a temporary directory, whose CSV must hold
     W = 256 and 512, each with and without ET, at a positive rate, with
     the engine that ran;
 11. several devices (parallel/): the mesh path, align_reads on phase 4's
     tile with device= every card, or ["cuda:0", "cuda:0"] on one card
     (two shards of 8192 lanes on two streams), after one call on one
     device for comparison, strings twice (the first call on new streams,
     timed apart) then packed: all 16384 alignments
     must equal phase 4's, the one-word kernel must launch once a shard a
     call and the multiword ones never; each shard's kernel time alone
     and the shards' together; then two real processes
     (``python3 chip_smoke.py --dist-worker``, gloo, rank r on
     cuda:(r mod device_count)) read phase 4's dataset from files and run
     align_reads_distributed: each rank's gathered list must equal phase
     4's strings; a worker that fails or outlives its limit fails the
     run; then the scaling harness twice into a temporary directory, the
     mesh (1 and 2 shards at 16384 pairs a shard, or 1..N cards) and
     --distributed 2, whose CSVs must hold positive rates and card, cards
     and processes columns that say what ran.

Then the kernels' JSON line, the card line again, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without a CUDA device the script exits 1 and prints no result. It imports
no JAX and nothing of the JAX package: its oracles are the port's own
pyref, cigar, utils.simulate and plain versions.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

WINDOWS_SOURCE = "scrooge_tpu_torch/csrc/genasm_windows.cu"
WINDOWS1_SOURCE = "scrooge_tpu_torch/csrc/genasm_windows1.cu"
WINDOWS_REPLACES = "scrooge_tpu/ops/engine_pallas.py:901"
WIDE_SOURCE = "scrooge_tpu_torch/csrc/genasm_windows_wide.cu"
# no pallas_call: the JAX package runs W > 256 on its XLA engine
WIDE_REPLACES = "scrooge_tpu/ops/engine_xla.py:105"
LAB_SOURCE = "scrooge_tpu_torch/csrc/genasm_fill_lab.cu"
LAB_REPLACES = "tools/kernel_lab.py:107"
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64    # Hopper SM: 4 partitions x 16 INT32 units
TB_STEP_OPS = 12           # int32 ops per traceback step: 3 bit tests
# INT32 instructions a DP cell takes per 64-bit word of its bitvectors
# (window_bound derives it), and a cell of row 0, which has no row above
# (fill_bound)
CELL_OPS_PER_WORD = 8
ROW0_OPS_PER_WORD = 4


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nvcc_release() -> str:
    from scrooge_tpu_torch.ops import _cuda

    out = subprocess.run([_cuda.find_nvcc(), "--version"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return next((ln.split("release")[1].split(",")[0].strip()
                 for ln in out.splitlines() if "release" in ln), "unknown")


def kernel_name(mangled: str) -> str:
    """'genasm_windows_kernel<2>' from a mangled entry name: the
    length-prefixed identifier that ends in '_kernel', and its template
    argument."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        at = m.start() + len(m.group(1))
        name = mangled[at : at + int(m.group(1))]
        if name.endswith("_kernel"):
            tmpl = re.match(r"ILi(\d+)E", mangled[at + len(name):])
            return name + (f"<{tmpl.group(1)}>" if tmpl else "")
    return mangled


def ptxas_summary(log: str) -> str:
    """Registers and spills per compiled function of an nvcc -Xptxas -v
    log, e.g. 'genasm_windows_kernel<2>: 96 regs, 0 B spill'."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = kernel_name(m.group(1))
            spill = "?"
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, {spill} B spill")
            name = None
    return "; ".join(out)


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


def int32_ops_per_s() -> float:
    """The card's INT32 rate: SMs x 64 INT32 lanes x the SM's max clock."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def window_bound(cfg, maxw, args, res, ops_rate):
    """Least time the window engine could take on this run's inputs:
    (ms, 'bytes' or 'operations', detail). ``res`` is the plain version's
    result on those inputs.

    Operations: every DP cell the run filled (its work counters; the
    kernel fills the same cells, d = 0 cells counted alike) at
    CELL_OPS_PER_WORD x NW INT32 instructions, plus TB_STEP_OPS a
    traceback step. The cell is
    ``(shl1(right) | pm) & shl1(topright) & shl1(top) & topright`` on NW
    64-bit words, 2 NW 32-bit halves, and the rate counts instructions:
    - logic: five terms take two three-input LOP3s a half, 4 NW;
    - shifts: shl1(topright) of a cell is shl1(top) of its neighbour in
      column i+1, so a cell makes two shifts by one; each half of a shift
      is one funnel shift (the lowest half a plain shift), 4 NW;
    so 8, 16, 24 and 32 instructions a cell at NW = 1..4. Bits at W and
    above need no mask (nothing reads them), and the PM select by text
    character, start-column selects and stores are not counted. This is
    a count of the recurrence, not a measured instruction mix.
    Bytes: the packed text and pattern chars read once, lengths and
    bases, every run, count and result written once."""
    from scrooge_tpu_torch.ops import engine

    nw = engine.num_words(cfg.W)
    cells = int(res.work[0].sum().item())
    steps = int(res.work[1].sum().item())
    ops = cells * CELL_OPS_PER_WORD * nw + steps * TB_STEP_OPS
    B = int(args[4].shape[0])
    read_chars = int(args[4].long().sum().item())
    # text and pattern: about as many text chars are consumed as read
    nbytes = (2 * read_chars // 4 + 16 * B
              + 2 * int(res.counts.long().sum().item()) + 4 * maxw * B
              + 24 * B)
    t_ops, t_bytes = ops / ops_rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else
            "bytes", dict(cells=cells, tb_steps=steps, int32_ops=ops,
                          bytes=nbytes))


def unrelated_pairs(cfg, seed, dev, B=512, length=1000):
    """B pairs whose text and read are drawn independently, staged; a
    quarter of the texts stop after 300 chars, so their later windows have
    no text (n = 0) and a window distance of m."""
    from scrooge_tpu_torch.ops import pack

    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, (B, length + 100), dtype=np.uint8)
    pattern = rng.integers(0, 4, (B, length), dtype=np.uint8)
    tlen = np.full(B, length + 100, np.int32)
    tlen[::4] = 300
    plen = rng.integers(length - 50, length + 1, B).astype(np.int32)
    tw = pack.pack_2bit(torch.from_numpy(text)).to(dev)
    base = torch.arange(B, dtype=torch.int64, device=dev) * (tw.shape[1] * 16)
    maxw = -(-cfg.max_windows(int(plen.max())) // 32) * 32
    return maxw, (tw, base, torch.from_numpy(tlen).to(dev),
                  pack.pack_2bit(torch.from_numpy(pattern)).to(dev),
                  torch.from_numpy(plen).to(dev))


def compare(cfg, maxw, args, label):
    """Kernel wrapper and plain engine on the same device tensors."""
    from scrooge_tpu_torch.ops import engine

    engine.align_windows(cfg, maxw, *args)  # build and warm up
    got, ms = timed(engine.align_windows, cfg, maxw, *args)
    want, plain_ms = timed(engine.align_windows_plain, cfg, maxw, *args)
    err = max_abs_diff(got, want)
    failed = int((got.failed != 0).sum().item())
    phase("kernel-vs-plain", shape=label,
          kernel=engine.window_kernel(cfg).source, W=cfg.W,
          K=cfg.K, O=cfg.O, NW=engine.num_words(cfg.W),
          B=int(args[4].shape[0]), maxw=maxw, kernel_ms=f"{ms:.3f}",
          plain_ms=f"{plain_ms:.3f}", max_abs_err=err, tolerance=0,
          failed_lanes=failed,
          fail_tb_lanes=int((got.failed & engine.FAIL_TB != 0).sum().item()))
    if err != 0:
        raise AssertionError(f"kernel and plain engine differ ({label})")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, plain=want)


def packed_cigars(packed):
    """All CIGAR strings of a PackedAlignments via the native formatter."""
    from scrooge_tpu_torch import native

    lens = np.diff(packed.run_offsets).astype(np.int32)
    n = len(lens)
    buf = np.zeros((max(int(lens.max(initial=0)), 1), n), np.uint16)
    lane = np.repeat(np.arange(n), lens)
    pos = np.arange(len(packed.runs)) - np.repeat(packed.run_offsets[:-1],
                                                  lens)
    buf[pos, lane] = packed.runs
    return native.format_cigars(buf, lens)


def drive_path(label, cfg, ds, prepared, dev, nsample, ncigar):
    """align_reads through the public API, strings then packed, with both
    window kernels' counts set to 0 just before and read just after;
    checks both outputs agree, ``nsample`` pairs (the longest read among
    them) equal pyref and ``ncigar`` CIGARs are valid. Returns the counts,
    {kernel: {key: launches}}, and the string output."""
    import scrooge_tpu_torch as st
    from scrooge_tpu_torch import pyref
    from scrooge_tpu_torch.cigar import is_valid_cigar
    from scrooge_tpu_torch.ops import _cuda

    window_kernels = (_cuda.GENASM_WINDOWS1, _cuda.GENASM_WINDOWS,
                      _cuda.GENASM_WINDOWS_WIDE)
    for k in window_kernels:
        k.counts.clear()
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
    counts = {k: dict(k.counts) for k in window_kernels}
    if sum(sum(c.values()) for c in counts.values()) < 1:
        raise AssertionError(f"{label}: the path never launched the kernel")
    n = len(ds.reads)
    if [a.cigar for a in strs] != packed_cigars(packed) or not np.array_equal(
            np.array([a.edit_distance for a in strs]),
            packed.edit_distances):
        raise AssertionError(f"{label}: strings and packed output disagree")
    lens = [len(r.content) for r in ds.reads]
    rng = random.Random(7)
    sample = sorted({int(np.argmax(lens))}
                    | set(rng.sample(range(n), nsample - 1)))
    bound = lambda r: cfg.max_windows(len(r.content)) * cfg.tb_limit + cfg.W
    for i in sample:
        r = ds.reads[i]
        s = r.locations[0].start_in_reference
        want = pyref.genasm(pyref.encode(ds.genome.content[s : s + bound(r)]),
                            pyref.encode(r.content), cfg)
        if (strs[i].edit_distance, strs[i].cigar) != want:
            raise AssertionError(f"{label}: pair {i} differs from pyref")
    for i in rng.sample(range(n), ncigar):
        r = ds.reads[i]
        if not is_valid_cigar(strs[i].cigar, strs[i].edit_distance,
                              ds.genome.content, r.content,
                              r.locations[0].start_in_reference):
            raise AssertionError(f"{label}: pair {i} has an invalid CIGAR")
    phase(label, W=cfg.W, K=cfg.K, O=cfg.O, pairs=n,
          launches=json.dumps({k.source: c for k, c in counts.items()}),
          retried_pairs=stats.retried_pairs,
          pyref_exact=len(sample), valid_cigars=ncigar,
          wall_s=f"{wall:.3f}", aligns_per_s=f"{n / wall:.1f}",
          packed_wall_s=f"{pwall:.3f}",
          packed_aligns_per_s=f"{n / pwall:.1f}",
          breakdown=repr(stats.breakdown()),
          packed_breakdown=repr(pstats.breakdown()))
    return counts, strs


def kernel_only(label, staged, n):
    from scrooge_tpu_torch.profiling import kernel_time

    samples = kernel_time.engine_ms(staged, reps=3, groups=3)
    rates = sorted(n * 1e3 / ms for ms in samples)
    phase(label, tile=n, ms=" ".join(f"{x:.3f}" for x in samples),
          aligns_per_s=f"{rates[1]:.1f}", min=f"{rates[0]:.1f}",
          max=f"{rates[-1]:.1f}")


def fill_bound(variant, wed, n, ops_rate):
    """Least time for NWIN windows of the fill lab on these inputs: (ms,
    'bytes' or 'operations'). ``wed`` is the plain version's per-lane wed
    and ``n`` each lane's n.

    Operations: a lane fills rows 0..wed of a window (every lane of the
    timed inputs hits; one that never did would fill rows up to K, and
    counting only its row 0 keeps the bound a lower bound). Of the W+1
    columns only those with i < n take work, min(max(n, 0), W+1) of
    them: a start column is the constant ones << (W-m+d). Row 0 has no
    row above, so its cell is ``shl1(right) | pm``, a shift and an OR on
    each 32-bit half, ROW0_OPS_PER_WORD (4) INT32 instructions. A row
    d >= 1 is the recurrence, CELL_OPS_PER_WORD (8) a cell as
    window_bound counts it, except in noff: its row above is the
    constant 0, so such a cell is 0 and takes none. Bytes: pmi, m and n
    read once; wed and the per-lane sum written once, and in full R's
    rows 0..wed (COLS words a row) once, since every window stores the
    same R."""
    from scrooge_tpu_torch.tools import kernel_lab as lab

    wed = wed.long().cpu()
    cols = n.long().cpu().clamp(0, lab.W + 1)
    deep = 0 if variant == "noff" else CELL_OPS_PER_WORD
    ops = lab.NWIN * int((cols * (ROW0_OPS_PER_WORD + wed * deep)).sum())
    B = int(wed.numel())
    nbytes = lab.W * B * 8 + B * (4 + 4 + 4 + 8)
    if variant == "full":
        nbytes += int((wed + 1).sum()) * lab.COLS * 8
    t_ops, t_bytes = ops / ops_rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def fill_check(v, nwin, m, n, pmi):
    """The fill-lab kernel against its plain version on the same inputs:
    (plain result, max abs err over wed and the total, or the count of R
    words that differ in full if larger)."""
    from scrooge_tpu_torch.tools import kernel_lab as lab

    got = lab.run(v, nwin, m, n, pmi, device=m.device)
    want = lab.run_plain(v, nwin, m, n, pmi)
    err = int((got.wed.long() - want.wed.long()).abs().max().item())
    err = max(err, abs(int(got.total) - int(want.total)))
    if v == "full":
        err = max(err, lab.r_mismatches(got, want))
    return want, err


def fill_lab(ops_rate):
    """Phase 8: returns the kernels-line entries of the fill-lab kernel."""
    from scrooge_tpu_torch.ops import _cuda
    from scrooge_tpu_torch.tools import kernel_lab as lab

    dev = torch.device("cuda")
    lab_own = (lab.M_DEFAULT, lab.W)  # the lab's own inputs: the timed ones
    checks = {v: [0, None] for v in lab.VARIANTS}  # max abs err, plain ms
    timed_in = {}  # B -> (n, each variant's plain wed) of the timed inputs
    for B, nwin, cases in ((2048, 2, lab.MN_CASES), (16384, 1, (lab_own,))):
        for mn in cases:
            m, n, pmi = (t.to(dev) for t in
                         lab.from_lab_layout(*lab.lab_inputs(B, 0, *mn)))
            for v in lab.VARIANTS:
                want, err = fill_check(v, nwin, m, n, pmi)
                fields = dict(variant=v, B=B, nwin=nwin, m=mn[0], n=mn[1],
                              plain_total=int(want.total), max_abs_err=err,
                              tolerance=0)
                if mn == lab_own:
                    timed_in.setdefault(B, (n, {}))[1][v] = want.wed
                if mn == lab_own:  # the timed inputs: plain's time too
                    _, plain_ms = timed(lab.run_plain, v, lab.NWIN, m, n,
                                        pmi)
                    fields["plain_ms"] = f"{plain_ms:.3f}"
                    if B == 2048:
                        checks[v][1] = plain_ms
                checks[v][0] = max(checks[v][0], err)
                phase("fill-lab-vs-plain", **fields)
                if err != 0:
                    raise AssertionError(f"fill-lab kernel and plain differ "
                                         f"({v}, B={B}, m={mn[0]}, "
                                         f"n={mn[1]})")

    # the entry point's own measurement, counts set to 0 just before
    _cuda.GENASM_FILL_LAB.counts.clear()
    torch.cuda.synchronize()
    rows = {B: lab.measure(lab.VARIANTS, batch=B, device=dev)
            for B in timed_in}
    counts = dict(_cuda.GENASM_FILL_LAB.counts)
    entries = []
    for k, v in enumerate(lab.VARIANTS):
        if counts.get(k, 0) < 1:
            raise AssertionError(f"the lab never launched variant {v}")
        bounds = {}
        for B, (n, wed) in timed_in.items():
            r = next(x for x in rows[B] if x["variant"] == v)
            if r["wed_sum"] != int(wed[v].sum()):
                raise AssertionError(f"fill-lab timed run differs from "
                                     f"plain ({v}, B={B})")
            bounds[B] = fill_bound(v, wed[v], n, ops_rate)
            phase("fill-lab", variant=v, B=B, nwin=lab.NWIN,
                  ms=f"{r['ms']:.3f}",
                  us_per_window=f"{r['us_per_window']:.3f}",
                  mean_wed=f"{r['mean_wed']:.3f}",
                  bound_ms=f"{bounds[B][0]:.6f}", bound_by=bounds[B][1],
                  share_of_bound=f"{bounds[B][0] / r['ms']:.4f}")
        r = next(x for x in rows[2048] if x["variant"] == v)
        entries.append({
            "name": f"genasm_fill_lab[{v}]", "route": "cuda",
            "source": LAB_SOURCE, "replaces": LAB_REPLACES,
            "launches": counts[k], "max_abs_err": checks[v][0],
            "ms": r["ms"], "plain_ms": checks[v][1],
            "bound_ms": bounds[2048][0], "bound_by": bounds[2048][1],
            "library_ms": None, "shape": f"B=2048 nwin={lab.NWIN}"})
    return entries


def captured(main, argv):
    """(exit code, stdout) of a CLI's main run in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def trace_shares(path):
    """From a torch.profiler chrome trace: (window-kernel launches, their
    ms, the device's busy share, the annotated call's ms) over the
    ``align_reads`` annotation. Busy is the union of kernel, copy and set
    intervals on the device within the call; idle is the rest."""
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
              and "genasm_windows1_kernel" in e.get("name", "")]
    return (len(window), sum(float(e["dur"]) for e in window) / 1e3,
            busy / (t1 - t0), (t1 - t0) / 1e3)


def file_path(ds, main_strs, small, dev, tmp):
    """Phase 9: the CLIs on the card, from files (see the docstring)."""
    import scrooge_tpu_torch as st
    from scrooge_tpu_torch import io as sio
    from scrooge_tpu_torch.cigar import affine_score, edits_in_cigar
    from scrooge_tpu_torch.cli import baseline_cli, tests_cli
    from scrooge_tpu_torch.ops import _cuda
    from scrooge_tpu_torch.utils.simulate import (SimulatedDataset,
                                                  write_dataset)

    one, multi = _cuda.GENASM_WINDOWS1, _cuda.GENASM_WINDOWS

    def reset():
        one.counts.clear()
        multi.counts.clear()
        torch.cuda.synchronize()

    # 1. the unit tests on the card
    reset()
    t0 = time.perf_counter()
    rc, out = captured(tests_cli.main, ["--unit_tests"])
    launches = sum(one.counts.values())
    passed = re.findall(r"^PASSED (\S+)$", out, re.M)
    phase("file-unit-tests", rc=rc, passed=",".join(passed),
          launches=launches, seconds=f"{time.perf_counter() - t0:.2f}")
    if rc != 0 or "FAILED" in out or len(passed) != 5 or launches < 1:
        raise AssertionError(f"tests_cli --unit_tests on the card:\n{out}")

    # 2. the bench dataset from files through performance_test
    bench = os.path.join(tmp, "bench")
    t0 = time.perf_counter()
    write_dataset(ds, bench)
    write_s = time.perf_counter() - t0
    files = [os.path.join(bench, f) for f in ("reference.fasta",
                                              "reads.fastq",
                                              "candidates.maf")]
    nbytes = sum(os.path.getsize(f) for f in files)
    # each file parsed alone: where the CLI's parse stage goes
    parse = {}
    for name, read, path in (("fasta", sio.read_genome, files[0]),
                             ("fastq", sio.read_fastq, files[1]),
                             ("maf", sio.read_maf, files[2])):
        t0 = time.perf_counter()
        parsed = read(path)
        parse[f"{name}_s"] = f"{time.perf_counter() - t0:.3f}"
        parse[f"{name}_records"] = (len(parsed.chromosome_starts)
                                    if name == "fasta" else len(parsed))
    phase("file-parse", **parse)
    reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        run = tests_cli.performance_test(*files, st.AlignConfig(), dev)
    total_s = time.perf_counter() - t0
    counts = {k.source: dict(k.counts) for k in (one, multi)}
    lines = buf.getvalue().splitlines()
    want = {(r.description, r.locations[0].start_in_reference):
            (a.edit_distance, a.cigar) for r, a in zip(ds.reads, main_strs)}
    keys = [(r.description, loc.start_in_reference) for r in run.reads
            for loc in r.locations]
    got = {k: (a.edit_distance, a.cigar)
           for k, a in zip(keys, run.alignments)}
    ns = run.stage_ns
    phase("file-path", pairs=len(run.alignments), files_mb=f"{nbytes / 1e6:.1f}",
          write_s=f"{write_s:.3f}",
          parse_reference_s=f"{ns['reference'] / 1e9:.3f}",
          parse_reads_seeds_join_s=f"{ns['reads_seeds'] / 1e9:.3f}",
          shape_s=f"{ns['shape'] / 1e9:.3f}",
          end_to_end_s=f"{ns['align'] / 1e9:.3f}",
          kernel_ms=f"{run.stats.core_ns / 1e6:.3f}",
          cigar_check_s=f"{ns['check'] / 1e9:.3f}",
          total_s=f"{total_s:.3f}",
          aligns_per_s=f"{len(run.alignments) * 1e9 / ns['align']:.1f}",
          launches=json.dumps(counts), retried=run.stats.retried_pairs,
          breakdown=repr(run.stats.breakdown()), cli=repr(lines))
    if any("FAILED" in ln for ln in lines) or len(lines) != 3:
        raise AssertionError(f"file path output: {lines}")
    if len(got) != len(ds.reads) or got != want:
        bad = sum(got.get(k) != v for k, v in want.items())
        raise AssertionError(f"file path: {bad} of {len(want)} alignments "
                             "differ from the library path's")
    if sum(counts[one.source].values()) < 1 or counts[multi.source]:
        raise AssertionError(f"file path launches: {counts}")

    # 3. the same files through the CLI with --profile
    trace_dir = os.path.join(tmp, "trace")
    reset()
    t0 = time.perf_counter()
    rc, out = captured(tests_cli.main, [f"--reference={files[0]}",
                                        f"--reads={files[1]}",
                                        f"--seeds={files[2]}",
                                        f"--profile={trace_dir}"])
    total_s = time.perf_counter() - t0
    n_kernels, kernel_ms, busy, span_ms = trace_shares(
        os.path.join(trace_dir, "trace.json"))
    phase("file-path-profile", rc=rc, total_s=f"{total_s:.3f}",
          launches=sum(one.counts.values()),
          window_kernels_in_trace=n_kernels,
          window_kernel_ms_in_trace=f"{kernel_ms:.3f}",
          align_reads_ms_in_trace=f"{span_ms:.3f}",
          device_busy_share=f"{busy:.4f}",
          device_idle_share=f"{1 - busy:.4f}",
          cli=repr(out.splitlines()[-3:]))
    if rc != 0 or "FAILED" in out or n_kernels < 1:
        raise AssertionError("tests_cli --profile on the bench files: "
                             f"rc={rc}, {n_kernels} window kernels traced")

    # 4. baseline_cli on 64 reads of 2 kbp
    sub = SimulatedDataset(genome=small.genome, reads=small.reads[:64])
    sdir = os.path.join(tmp, "small")
    write_dataset(sub, sdir)
    reset()
    t0 = time.perf_counter()
    rc, out = captured(baseline_cli.main, [
        f"--reference={sdir}/reference.fasta", f"--reads={sdir}/reads.fastq",
        f"--seeds={sdir}/candidates.maf", "--accuracy", "--cigar",
        "--algorithms=genasm_device,exact"])
    cli_s = time.perf_counter() - t0
    launches = sum(one.counts.values())
    rows = [ln for ln in out.splitlines() if ln.startswith("pair_idx=")]
    alns = st.align_reads(small.genome, sub.reads, st.AlignConfig(
        batch_tile=2048), device=dev)
    expect = []
    for i, (r, a) in enumerate(zip(sub.reads, alns)):
        s = r.locations[0].start_in_reference
        expect.append(f"pair_idx={i} score={affine_score(a.cigar)} "
                      f"cigar={a.cigar} read={r.content} "
                      f"reference={small.genome.content[s : s + len(r.content)]}")
    edits = lambda ln: edits_in_cigar(ln.split()[2][len("cigar="):])
    phase("file-baseline", rc=rc, pairs=len(expect), seconds=f"{cli_s:.2f}",
          launches=launches, genasm_device_rows_equal=rows[:64] == expect,
          exact_rows=len(rows[64:]),
          exact_edits_at_most_genasm=sum(edits(e) <= edits(g) for e, g in
                                         zip(rows[64:], rows[:64])))
    if rc != 0 or rows[:64] != expect or len(rows) != 128 or launches < 1:
        raise AssertionError("baseline_cli genasm_device lines differ from "
                             "align_reads on the card")


def wide_windows(ds, prepared, dev, ops_rate, tmp):
    """Phase 10 (see the docstring): returns the kernels-line entry of the
    wide kernel."""
    import scrooge_tpu_torch as st
    from scrooge_tpu_torch.ops import _cuda, engine
    from scrooge_tpu_torch.profiling import kernel_time, sweep
    from scrooge_tpu_torch.utils.simulate import SimulatedDataset

    wide = _cuda.GENASM_WINDOWS_WIDE
    for (W, K, O), B in (((257, 257, 129), 256), ((320, 320, 161), 256),
                         ((512, 512, 257), 256), ((512, 512, 0), 256),
                         ((1024, 1024, 513), 64), ((2048, 2048, 1025), 64)):
        cfg = st.AlignConfig(W=W, K=K, O=O)
        maxw, args = random_pairs(cfg, W + O, dev, B=B, length=2000)
        compare(cfg, maxw, args, f"{B}x2kbp")
    cfg = st.AlignConfig(W=512, K=64, O=257)
    maxw, args = unrelated_pairs(cfg, 164, dev, B=256)
    want = compare(cfg, maxw, args, "256x1kbp-unrelated")["plain"]
    if int((want.failed & engine.FAIL_TB != 0).sum().item()) == 0:
        raise AssertionError("unrelated pairs at W=512 K=64: no FAIL_TB lane")

    # one tile split by a small scratch budget against one launch
    cfg = st.AlignConfig(W=512, K=512, O=257)
    maxw, args = random_pairs(cfg, 5, dev, B=256, length=2000)
    one = engine.align_windows(cfg, maxw, *args)
    budget = 8 * sum(engine.scratch_words(cfg, 64))  # 64 pairs a launch
    chunks = engine.launch_chunks(cfg, 256, budget)
    before = wide.counts[8]
    split = engine._align_windows_cuda(cfg, maxw, *args, budget_bytes=budget)
    torch.cuda.synchronize()
    err = max_abs_diff(one, split)
    phase("wide-split", W=cfg.W, B=256, budget_bytes=budget,
          launches=wide.counts[8] - before, chunks=len(chunks),
          max_abs_err=err, tolerance=0)
    if err != 0 or wide.counts[8] - before != len(chunks) or len(chunks) < 2:
        raise AssertionError("a split tile differs from one launch")

    # the slice's path: align_reads at W=512 on 1024 bench reads
    cfg = st.AlignConfig(W=512, K=512, O=257, batch_tile=1024)
    sub = SimulatedDataset(genome=ds.genome, reads=ds.reads[:1024])
    staged = kernel_time.stage_mapped(prepared, sub.reads, cfg, dev)
    tile = compare(cfg, staged[1], staged[2], "w512 path tile")
    counts, _ = drive_path("w512-path", cfg, sub, prepared, dev, 4, 128)
    launches = counts[wide].get(8, 0)
    if launches < 1 or any(counts[k] for k in counts if k is not wide):
        raise AssertionError(f"the W=512 path's launches: {counts}")
    kernel_only("w512-kernel-only", staged, len(sub.reads))
    bound_ms, bound_by, detail = window_bound(cfg, staged[1], staged[2],
                                              tile["plain"], ops_rate)
    phase("bound", kernel="genasm_windows_wide[NW=8]", W=cfg.W,
          bound_ms=f"{bound_ms:.6f}", bound_by=bound_by, **detail)

    # the sweep entry point on the card
    out = os.path.join(tmp, "sweep")
    t0 = time.perf_counter()
    rc = sweep.main(["device", "simulated:1024:10000", "--families", "WO",
                     "--max_W", "512", "--max_experiments", "2",
                     "--profile_dir", out])
    with open(os.path.join(out, "simulated_1024_10000_device_sweep_WO.csv")
              ) as f:
        rows = list(csv.DictReader(f))
    phase("sweep", rc=rc, seconds=f"{time.perf_counter() - t0:.2f}",
          rows=repr([(r["W"], r["early termination"], r["batch"],
                      r["aligns/second"], r["engine"]) for r in rows]))
    want = {("256", "genasm_windows"), ("512", "genasm_windows_wide")}
    got = {(r["W"], r["early termination"], r["engine"]) for r in rows
           if float(r["aligns/second"]) > 0}
    if rc != 0 or got != {(w, et, e) for w, e in want
                          for et in ("False", "True")}:
        raise AssertionError(f"sweep rows: {rows}")
    return {"name": "genasm_windows_wide[NW=8]", "route": "cuda",
            "source": WIDE_SOURCE, "replaces": WIDE_REPLACES,
            "launches": launches, "max_abs_err": tile["max_abs_err"],
            "ms": tile["ms"], "plain_ms": tile["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": f"W=512 K=512 O=257 B={staged[3]}"}


def mesh_path(ds, prepared, main_strs, cfg):
    """Phase 11, part 1: align_reads on a mesh (see the docstring)."""
    import scrooge_tpu_torch as st
    from scrooge_tpu_torch.ops import _cuda, engine
    from scrooge_tpu_torch.parallel import mesh as M
    from scrooge_tpu_torch.profiling import kernel_time

    ncards = torch.cuda.device_count()
    mesh = M.make_mesh(devices=[f"cuda:{i}" for i in range(ncards)]
                       if ncards >= 2 else ["cuda:0", "cuda:0"])
    one, others = _cuda.GENASM_WINDOWS1, (_cuda.GENASM_WINDOWS,
                                          _cuda.GENASM_WINDOWS_WIDE)
    # one device in this process's state, beside the mesh
    t0 = time.perf_counter()
    st.align_reads(prepared, ds.reads, cfg, device=mesh[0])
    one_wall = time.perf_counter() - t0
    for k in _cuda.KERNELS:
        k.counts.clear()
    torch.cuda.synchronize()
    walls = []
    for _ in range(2):  # the first call on new streams, then again
        t0 = time.perf_counter()
        strs, stats = st.align_reads(prepared, ds.reads, cfg,
                                     return_stats=True, device=mesh)
        walls.append(time.perf_counter() - t0)
    wall = walls[-1]
    strs_launches = one.counts[1]
    t0 = time.perf_counter()
    packed, pstats = st.align_reads(prepared, ds.reads, cfg,
                                    return_stats=True, return_packed=True,
                                    device=mesh)
    pwall = time.perf_counter() - t0
    counts = {k.source: dict(k.counts) for k in (one, *others)}
    bad = sum((a.edit_distance, a.cigar) != (b.edit_distance, b.cigar)
              for a, b in zip(strs, main_strs))
    agree = ([a.cigar for a in strs] == packed_cigars(packed)
             and np.array_equal(np.array([a.edit_distance for a in strs]),
                                packed.edit_distances))

    # each shard's kernel alone, then the shards together on their streams
    lanes = M.shard_lanes(len(ds.reads), len(mesh))
    staged = [kernel_time.stage_mapped(
        prepared, [ds.reads[i] for i in lk], cfg, dev)
        for lk, dev in zip(lanes, mesh)]
    alone = [min(kernel_time.engine_ms(x, reps=3, groups=3)) for x in staged]

    budgets = M.scratch_budgets(mesh)

    def both():
        M.run_sharded(mesh, lambda k, dev: engine.align_windows(
            cfg, staged[k][1], *staged[k][2], budget_bytes=budgets[k]))
        for d in set(mesh):
            torch.cuda.synchronize(d)

    both()
    t0 = time.perf_counter()
    for _ in range(3):
        both()
    together = (time.perf_counter() - t0) / 3 * 1e3
    phase("mesh-path", cards=len(set(mesh)), shards=len(mesh),
          mesh=repr([str(d) for d in mesh]), pairs=len(strs),
          equal_to_main_path=len(strs) - bad, packed_agrees=agree,
          launches=json.dumps(counts), retried_pairs=stats.retried_pairs,
          one_device_wall_s=f"{one_wall:.3f}",
          first_wall_s=f"{walls[0]:.3f}", wall_s=f"{wall:.3f}",
          aligns_per_s=f"{len(strs) / wall:.1f}",
          packed_wall_s=f"{pwall:.3f}",
          packed_aligns_per_s=f"{len(strs) / pwall:.1f}",
          summed_stages=repr(stats.breakdown()),
          packed_summed_stages=repr(pstats.breakdown()),
          shard_kernel_ms=" ".join(f"{x:.3f}" for x in alone),
          shards_together_ms=f"{together:.3f}")
    if bad or len(strs) != len(main_strs) or not agree:
        raise AssertionError(f"mesh path: {bad} alignments differ from the "
                             f"main path's; strings and packed agree: "
                             f"{agree}")
    if (strs_launches < 2 * len(mesh) or counts[one.source].get(1, 0)
            < 3 * len(mesh) or any(counts[k.source] for k in others)):
        raise AssertionError(f"mesh path launches: {counts}")


def dist_worker(rank, world, port, data_dir, out_path) -> int:
    """One process of phase 11's distributed part: reads the dataset from
    its files, runs align_reads_distributed on cuda:(rank mod
    device_count), writes every gathered alignment to ``out_path`` as
    'description TAB start TAB edit distance TAB cigar' lines, and prints
    one JSON line of its timings, the gather's alone among them."""
    import socket

    import torch.distributed as tdist

    import scrooge_tpu_torch as st
    from scrooge_tpu_torch import io as sio
    from scrooge_tpu_torch.parallel import distributed as dist

    t_start = time.perf_counter()
    rank, world = int(rank), int(world)
    dist.initialize(init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                    rank=rank, timeout_s=300)
    try:
        t0 = time.perf_counter()
        genome, reads = sio.load_dataset(data_dir)
        load_s = time.perf_counter() - t0
        dev = dist.default_device()
        cfg = st.AlignConfig(batch_tile=16384)
        # the card's context and the process's first call, off the clock
        st.align_reads(genome, reads[:256], cfg, device=dev)
        tdist.barrier()
        t0 = time.perf_counter()
        alns = dist.align_reads_distributed(genome, reads, cfg, device=dev)
        align_s = time.perf_counter() - t0
        local, idx = dist.align_reads_distributed(genome, reads, cfg,
                                                  gather=False, device=dev)
        tdist.barrier()
        t0 = time.perf_counter()
        again = dist.gather_alignments(local, idx, len(alns))
        gather_s = time.perf_counter() - t0
        if again != alns:
            raise AssertionError("a second gather differs from the first")
        keys = [(r.description, loc.start_in_reference) for r in reads
                for loc in r.locations]
        with open(out_path, "w") as f:
            for (desc, start), a in zip(keys, alns):
                f.write(f"{desc}\t{start}\t{a.edit_distance}\t{a.cigar}\n")
        print(json.dumps({
            "rank": rank, "host": socket.gethostname(), "device": str(dev),
            "local_pairs": len(local), "load_s": load_s, "align_s": align_s,
            "gather_bytes": sum(len(a.cigar) for a in local) + 24 * len(local),
            "gather_s": gather_s,
            "seconds": time.perf_counter() - t_start}), flush=True)
    finally:
        dist.destroy()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(procs, logs, timeout_s, label):
    """Wait for every process within ``timeout_s``; kill the rest on the
    way out. Raises when one failed or ran out of time; returns each
    process's standard output."""
    try:
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{label}: a process outlived {timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    if any(p.returncode for p in procs):
        raise AssertionError(f"{label} failed: " + " | ".join(
            f"rc={p.returncode} {e[-1500:]}" for p, (_, e) in zip(procs,
                                                                  texts)))
    return [o for o, _ in texts]


def distributed_path(ds, main_strs, tmp):
    """Phase 11, part 2: two processes with gloo (see the docstring)."""
    from scrooge_tpu_torch.utils.simulate import write_dataset

    data = os.path.join(tmp, "bench")
    write_dataset(ds, data)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(2)]
    outs = [os.path.join(tmp, f"rank{r}.tsv") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", str(r),
         "2", str(port), data, outs[r]], cwd=ROOT, env=env,
        stdout=logs[r][0], stderr=logs[r][1]) for r in range(2)]
    texts = _run(procs, logs, 600, "distributed workers")
    wall = time.perf_counter() - t0
    rows = [json.loads(t.strip().splitlines()[-1]) for t in texts]
    want = {(r.description, r.locations[0].start_in_reference):
            (a.edit_distance, a.cigar) for r, a in zip(ds.reads, main_strs)}
    equal = []
    for out in outs:
        got = {}
        with open(out) as f:
            for ln in f:
                desc, start, ed, cigar = ln.rstrip("\n").split("\t")
                got[(desc, int(start))] = (int(ed), cigar)
        equal.append(sum(got.get(k) == v for k, v in want.items()))
    fields = {}
    for r in rows:
        for k in ("device", "local_pairs", "load_s", "align_s",
                  "gather_bytes", "gather_s", "seconds"):
            v = r[k]
            fields[f"rank{r['rank']}_{k}"] = (f"{v:.3f}"
                                              if isinstance(v, float) else v)
    phase("distributed", cards=len({(r["host"], r["device"]) for r in rows}),
          processes=len(rows), pairs=len(want),
          equal_to_main_path=" ".join(map(str, equal)),
          wall_s=f"{wall:.3f}", **fields)
    if any(e != len(want) for e in equal):
        raise AssertionError(f"distributed: gathered lists equal to the main "
                             f"path's: {equal} of {len(want)}")


def scaling_path(kind, tmp):
    """Phase 11, part 3: the scaling harness, on the mesh and over two
    processes (see the docstring)."""
    ncards = torch.cuda.device_count()
    runs = {"mesh": ["--shards", str(max(2, ncards)), "--per_device",
                     "16384", "--read_len", "10000", "--reps", "3"],
            "distributed": ["--distributed", "2", "--per_process", "8192",
                            "--read_len", "10000"]}
    for name, args in runs.items():
        out = os.path.join(tmp, f"scaling_{name}.csv")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "scrooge_tpu_torch.profiling.scaling",
             "--device", "cuda", *args, "--out", out], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"scaling {name}: rc={proc.returncode} "
                                 f"{proc.stderr[-2000:]}")
        with open(out) as f:
            rows = list(csv.DictReader(f))
        count = "shards" if name == "mesh" else "processes"
        phase(f"scaling-{name}", seconds=f"{time.perf_counter() - t0:.2f}",
              rows=repr([{k: r[k] for k in (count, "cards", "card",
                                            "aligns_per_second",
                                            "weak_scaling_efficiency")}
                         for r in rows]))
        for r in rows:
            n = int(r[count])
            if not (float(r["aligns_per_second"]) > 0 and r["card"] == kind
                    and int(r["cards"]) == min(n, ncards)):
                raise AssertionError(f"scaling {name} row: {r}")
        if name == "distributed" and [int(r[count]) for r in rows] != [1, 2]:
            raise AssertionError(f"scaling distributed rows: {rows}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import scrooge_tpu_torch as st
    from scrooge_tpu_torch.ops import _cuda, engine
    from scrooge_tpu_torch.profiling import kernel_time
    from scrooge_tpu_torch.utils.simulate import simulate_dataset

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 1. toolchain ----
    try:
        import triton  # noqa: F401

        has_triton = True
    except ImportError:
        has_triton = False
    card = nvidia_smi("name,power.limit")
    ops_rate = int32_ops_per_s()
    phase("toolchain", torch=torch.__version__, cuda=torch.version.cuda,
          device=repr(kind), nvcc=nvcc_release(), triton=has_triton,
          int32_tops=f"{ops_rate / 1e12:.3f}")
    print(card, flush=True)

    # ---- 2. build ----
    for src, secs in _cuda.build_all().items():
        k = next(k for k in _cuda.KERNELS if k.source == src)
        summary = ptxas_summary(k.build_log)
        phase("build", source=src, seconds=f"{secs:.2f}",
              ptxas=repr(summary))
        if any(int(x) for x in re.findall(r"(\d+) B spill", summary)):
            raise AssertionError(f"{src} spills to local memory: {summary}")

    # ---- 3. kernel against plain ----
    for W, K, O in ((64, 64, 33), (32, 32, 17), (96, 96, 49),
                    (128, 128, 65), (128, 128, 2), (192, 192, 97),
                    (256, 256, 129)):
        cfg = st.AlignConfig(W=W, K=K, O=O)
        maxw, args = random_pairs(cfg, W, dev)
        compare(cfg, maxw, args, "512x1kbp")
    for W, K, O in ((64, 64, 33), (64, 16, 33), (128, 128, 65),
                    (128, 16, 65)):
        cfg = st.AlignConfig(W=W, K=K, O=O)
        maxw, args = unrelated_pairs(cfg, 100 + K, dev)
        want = compare(cfg, maxw, args, "512x1kbp-unrelated")["plain"]
        # no window of m <= W chars needs more than W edits
        fail_tb = int((want.failed & engine.FAIL_TB != 0).sum().item())
        if (K == 16) != (fail_tb > 0):
            raise AssertionError(f"unrelated pairs at W={W} K={K}: "
                                 f"{fail_tb} FAIL_TB lanes")

    cfg = st.AlignConfig(W=64, K=64, O=33, early_termination=True,
                         batch_tile=16384)
    t0 = time.perf_counter()
    ds = simulate_dataset(genome_len=1_000_000, num_reads=16384,
                          read_len=10000, accuracy=0.95, seed=7)
    prepared = st.prepare_genome(ds.genome)
    staged = kernel_time.stage_mapped(prepared, ds.reads, cfg, dev)
    phase("dataset", reads=len(ds.reads),
          seconds=f"{time.perf_counter() - t0:.2f}")
    main_tile = compare(cfg, staged[1], staged[2], "main-path tile")
    windows = {1: (cfg, staged, main_tile)}

    # ---- 4. main path ----
    counts = {}
    counts[1], main_strs = drive_path("main-path", cfg, ds, prepared, dev, 16,
                                      512)
    if sum(counts[1][_cuda.GENASM_WINDOWS].values()) != 0:
        raise AssertionError("the main path launched the multiword kernel")

    # ---- 5. kernel-only time ----
    kernel_only("kernel-only", staged, len(ds.reads))

    # ---- 6. quick-start pair ----
    a = st.align_pairs(["AAAACCCCGGGGTTTT"], ["CCCCGGGGTTTTAAAA"],
                       device=dev)[0]
    phase("quick-start", edit_distance=a.edit_distance, cigar=a.cigar)
    if (a.edit_distance, a.cigar) != (8, "4D12=4I"):
        raise AssertionError("quick-start pair differs from 8 4D12=4I")

    # ---- 7. wide path ----
    wcfg = st.AlignConfig(W=128, K=128, O=65, batch_tile=16384)
    wstaged = kernel_time.stage_mapped(prepared, ds.reads, wcfg, dev)
    wide_tile = compare(wcfg, wstaged[1], wstaged[2], "wide tile")
    windows[2] = (wcfg, wstaged, wide_tile)
    counts[2], _ = drive_path("wide-path", wcfg, ds, prepared, dev, 16, 512)
    kernel_only("wide-kernel-only", wstaged, len(ds.reads))
    small = simulate_dataset(genome_len=200_000, num_reads=512,
                             read_len=2000, accuracy=0.95, seed=11)
    sprep = st.prepare_genome(small.genome)
    for nw, (W, K, O) in ((3, (192, 192, 97)), (4, (256, 256, 129))):
        c = st.AlignConfig(W=W, K=K, O=O, batch_tile=512)
        sst = kernel_time.stage_mapped(sprep, small.reads, c, dev)
        windows[nw] = (c, sst, compare(c, sst[1], sst[2], "512x2kbp"))
        counts[nw], _ = drive_path(f"wide-path-w{W}", c, small, sprep, dev,
                                   4, 128)

    kernels = []
    rows = [(nw, engine.window_kernel(c), c, sst, cmp, counts[nw])
            for nw, (c, sst, cmp) in sorted(windows.items())]
    for nw, kern, c, sst, cmp, cnt in rows:
        launches = cnt[kern].get(nw, 0)
        name = ("genasm_windows1[NW=1]" if kern is _cuda.GENASM_WINDOWS1
                else f"genasm_windows[NW={nw}]")
        if launches < 1:
            raise AssertionError(f"{name} never launched on its path")
        bound_ms, bound_by, detail = window_bound(c, sst[1], sst[2],
                                                  cmp["plain"], ops_rate)
        phase("bound", kernel=name, W=c.W, bound_ms=f"{bound_ms:.6f}",
              bound_by=bound_by, **{k: v for k, v in detail.items()})
        kernels.append({
            "name": name, "route": "cuda",
            "source": (WINDOWS1_SOURCE if kern is _cuda.GENASM_WINDOWS1
                       else WINDOWS_SOURCE),
            "replaces": WINDOWS_REPLACES,
            "launches": launches, "max_abs_err": cmp["max_abs_err"],
            "ms": cmp["ms"], "plain_ms": cmp["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": f"W={c.W} K={c.K} O={c.O} B={sst[3]}"})

    # ---- 8. fill lab ----
    kernels += fill_lab(ops_rate)

    # ---- 9. file path ----
    with tempfile.TemporaryDirectory(prefix="scrooge_file_path_") as tmp:
        file_path(ds, main_strs, small, dev, tmp)

    # ---- 10. windows wider than 256 ----
    with tempfile.TemporaryDirectory(prefix="scrooge_wide_") as tmp:
        kernels.append(wide_windows(ds, prepared, dev, ops_rate, tmp))

    # ---- 11. several devices ----
    mesh_path(ds, prepared, main_strs, cfg)
    with tempfile.TemporaryDirectory(prefix="scrooge_parallel_") as tmp:
        distributed_path(ds, main_strs, tmp)
        scaling_path(kind, tmp)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(*sys.argv[2:]))
    sys.exit(main())
