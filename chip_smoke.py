"""Smoke run of the torch port on one NVIDIA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py [--against PATH ...]

Phases, one line each:
  1. toolchain: torch, CUDA, nvcc, triton, and the card as nvidia-smi
     reports it (its own line);
  2. build: compile the five kernel sources from csrc/ with nvcc, one
     process each, started together; registers and spills of every
     instantiation (each window kernel with early termination and
     without), and no kernel may spill;
  3. kernel against plain: the window kernel and the plain torch engine on
     the same device tensors, 512 pairs of ~1 kbp at W/K/O 64/64/33,
     32/32/17, 96/96/49, 128/128/65, 128/128/2 (two traceback mask words,
     every R word stored), 192/192/97 and 256/256/129 (W <= 64 on the
     one-word kernel genasm_windows1.cu, two and three words on
     genasm_windows.cu, four on genasm_windows_wide.cu, a warp a pair at
     G = 4); then 512 unrelated pairs of 1 kbp at 64/64/33
     and 128/128/65 (a quarter of the texts run out: rows up to K and the
     row pair that computes row K+1) and at 64/16/33 and 128/16/65
     (FAIL_TB lanes); then 512 of those ~1 kbp pairs as strings through
     align_pairs at 96/96/49 (tb_limit 47: uint8 runs read back), strings
     then packed, which must agree, equal pyref on sampled pairs, carry
     valid CIGARs, launch genasm_windows.cu and read back one byte a run
     entry; then the main path's own tile (16384 reads of 10 kbp at
     64/64/33); every output must be identical;
  4. main path: align_reads on the bench workload (simulate_dataset(
     1 Mbp genome, 16384 reads x 10 kbp, 95 % accuracy, seed 7), W=64
     K=64 O=33, one tile of 16384), strings then packed; the one-word
     kernel's launch count must grow and the multiword kernel must not
     launch, the token kernel must launch once a tile of each call
     (its launch counter), both outputs must agree,
     sampled pairs must equal pyref and carry valid CIGARs;
  5. kernel-only time of the same tile, CUDA events, 3 x 3 calls;
  6. the README's quick-start pair;
  7. wide path: the same tile at W=128 K=128 O=65 (two words), kernel
     against plain, then align_reads checked as in phase 4 (its runs read
     back as one byte an entry, tb_limit 63, so the token kernel must
     not launch), and its kernel-only time;
     then align_reads at 192/192/97 and 256/256/129 on 512 reads of
     2 kbp, each held against plain and pyref (two bytes a run entry);
     then the benchmark cell's tile, 256/256/129 on the first 1,024 of
     phase 4's reads (one tile, the wide kernel at G = 4): kernel against
     plain, align_reads checked as in phase 4 with only the wide kernel
     launching at key 4, its kernel-only time and its bound;
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
 10. windows wider than 256 (genasm_windows_wide.cu, a warp a pair, in
     groups of G threads that each fill a row of a pass): its registers
     and spills at G = 8, 16 and 32; the kernel against plain on 256 pairs
     of ~2 kbp at W/K/O
     257/257/129 (one bit in the top word), 320/320/161, 512/512/257 and
     512/512/0 (G = 8) and on 64 pairs at 1024/1024/513 (G = 16) and
     2048/2048/1025 (G = 32); on 256 unrelated pairs at 512/64/257, which
     must give FAIL_TB lanes; one tile split into several launches by a
     small scratch budget against one launch; then the slice's path,
     align_reads at W=512 K=512 O=257 on the first 1024 reads of phase
     4's dataset (one tile), strings then packed, checked as in phase 4
     with the wide kernel's launch count, the kernel against plain on
     that tile, its kernel-only time, and its bound beside the bytes of R
     the tile must write (a second floor of the kernel); then align_reads
     at 1024/1024/513 and 2048/2048/1025 on the first 64 of phase 7's
     2 kbp reads, each tile against plain and checked as in phase 7, with
     its bound and launch count; then the sweep entry point on the
     card, ``device simulated:1024:10000 --families WO --max_W 512
     --max_experiments 2`` into a temporary directory, whose CSV must hold
     W = 256 and 512, each with and without ET, at a positive rate, with
     the engine that ran, each ET=False row slower than its ET=True twin;
 11. several devices (parallel/): the mesh path, align_reads on phase 4's
     tile with device= every card, or ["cuda:0", "cuda:0"] on one card
     (two shards of 8192 lanes on two streams), after one call on one
     device for comparison, strings twice (the first call on new streams,
     timed apart) then packed: all 16384 alignments
     must equal phase 4's, the one-word kernel and the token kernel must
     launch once a shard a call and the multiword ones never; each
     shard's kernel time alone
     and the shards' together; then two real processes
     (``python3 chip_smoke.py --dist-worker``, gloo, rank r on
     cuda:(r mod device_count)) read phase 4's dataset from files and run
     align_reads_distributed: each rank's gathered list must equal phase
     4's strings; a worker that fails or outlives its limit fails the
     run; then the scaling harness twice into a temporary directory, the
     mesh (1 and 2 shards at 16384 pairs a shard, or 1..N cards) and
     --distributed 2, whose CSVs must hold positive rates and card, cards
     and processes columns that say what ran;
 12. the tile pipeline: align_reads on phase 4's dataset in 16 tiles
     (batch_tile 1024) at 64/64/33 and 128/128/65 on the card, and at
     64/64/33 on ["cuda:0", "cuda:0"] (every tile two shards), strings
     then packed, and at 64/64/33 once more with the CIGARs decoded on
     one thread (api.DECODE_THREADS = 1): every alignment must equal the
     single-tile call's of phase 4 or 7 for the same pair, every tile
     (shard) must launch its window kernel, the token kernel must launch
     exactly once a tile (shard) at W=64 and never at W=128, and at
     W=128 both modes must
     read back one byte a run entry; each call's wall clock,
     AlignStats stages and launches, then the same call under
     torch.profiler for the device's busy and idle share of it
     (profiling/pipeline.py);
 13. early termination off (each kernel's instantiation with
     engine.ET_OFF in its key, which fills every row 0..K): each window
     kernel against its plain version with ET off, 512 x 1 kbp at W =
     64, 128, 192 and 256, the unrelated pairs of phase 3, and 64 x 2 kbp
     at W = 320, 512, 1024 and 2048 at a reduced K; ET on against ET off
     on the bench tile at W=64 and W=128 and on 1,024 bench reads at
     W=256 and W=512, in turns with CUDA events, each beside its bound (the ET-off
     bound from the ET-on plain run's count of one row's cells, times
     K+1) and its launches; then every path of phases 4, 7 and 10 again
     through align_reads with ET off, counts set to 0 just before: the
     output must equal the ET-on path's and only the ET-off instantiation
     may launch;
 14. the bench: ``python -m scrooge_tpu_torch.bench`` in a process of its
     own, at its defaults (32,768 reads of 10 kbp in two tiles, W=64) and
     at the short-read point BENCH_W=32 BENCH_O=17 BENCH_READ_LEN=150;
     each run must exit 0 (it checks its own output against pyref, CIGAR
     validity and packed against strings), its JSON line must hold every
     key of the JAX bench's line and ``card``, and each of its passes
     (end to end, kernel-only, staged) must launch the one-word kernel;
     each bench line gives the best strings and packed walls;
 15. packed assembly into pair order: api._assemble_packed_parts on the
     bench's shape (phase 4's reads twice, 32,768 pairs in two tiles of
     16,384 at W=64), its parts kept from one align_reads call, timed on
     the card's host in the API's permuted order and relabelled into the
     identity order; both must equal phase 4's strings for their pairs,
     the identity order must not scatter and the permuted one scatter
     once a tile;
 16. the token kernel (csrc/genasm_tokens.cu) on a tile of w64_chained's
     shape (1,024 pairs of PBSIM2 10 kbp reads, true candidates and
     Poisson(1) decoys, 64/64/33, the window kernel's results): its rows
     and token totals must equal the torch chain's it replaces on the card
     (compact_tokenize, the totals' sync, compact_tokens) byte for byte;
     both times in turns, the device memory each adds, and the kernel's
     bound from the bytes it must move; the kernels line gives it phase
     4's launches, those of the main path;
 17. the one-word window kernel (a warp a pair) on the same tile shape:
     its output and row counters against the plain version's, its bound,
     its row fill (row work over row slots), and the instantiation
     without early termination (key 257) against the same output; the
     kernels line gives it phase 4's launches. With ``--against PATH
     ...``, each file given (another version of csrc/genasm_windows1.cu,
     such as the parent's from ``git archive``) is held to the same
     outputs, ET on and off, and timed with the kernel in turns; the
     window lab times the kernel's variants
     (``python -m scrooge_tpu_torch.tools.window_lab``).

In phases 3, 4, 7, 10 and 12 a path whose runs come back as runs (tb_limit
> 31) prints its readback bytes beside its run entries (readback_check):
one byte an entry where tb_limit <= 63, two above.

Beside phase 4's and 7's bound lines, a sol line gives the bound that
profiling/model.py reckons for the bench tile from expected counts alone
(``model.sol_estimate``); the bounds themselves come from that module's
window_bound, fill_bound and r_floor on the plain engine's counters.

Then the kernels' JSON line, the card line again, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without a CUDA device the script exits 1 and prints no result. It imports
no JAX and nothing of the JAX package: its oracles are the port's own
pyref, cigar, utils.simulate and plain versions.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import io
import json
import os
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
# no pallas_call above four words: the JAX package runs W > 256 on its
# XLA engine (at four words the wide kernel replaces WINDOWS_REPLACES)
WIDE_REPLACES = "scrooge_tpu/ops/engine_xla.py:105"
LAB_SOURCE = "scrooge_tpu_torch/csrc/genasm_fill_lab.cu"
LAB_REPLACES = "tools/kernel_lab.py:107"
ROOT = os.path.dirname(os.path.abspath(__file__))

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
    """'genasm_windows_kernel<2, true>' from a mangled entry name: the
    length-prefixed identifier that ends in '_kernel', and its int and
    bool template arguments."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        at = m.start() + len(m.group(1))
        name = mangled[at : at + int(m.group(1))]
        if name.endswith("_kernel"):
            tmpl = re.match(r"I((?:L[ib]\d+E)+)E", mangled[at + len(name):])
            if not tmpl:
                return name
            args = [("true" if v == "1" else "false") if t == "b" else v
                    for t, v in re.findall(r"L([ib])(\d+)E", tmpl.group(1))]
            return f"{name}<{', '.join(args)}>"
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
    if a.rows is not None and b.rows is not None:  # one word: row counters
        diffs.append(int((a.rows.cpu() - b.rows.cpu()).abs().max().item()))
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


def pair_codes(seed, B, length, rate):
    """(text (B, length+100), pattern (B, length+60), pattern lengths) as
    2-bit codes: each pattern ~length bp of its text with substitutions
    and indels at ``rate`` in all."""
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
    return text, pattern, plen


def random_pairs(cfg, seed, dev, B=512, length=1000, rate=0.05):
    """B pairs of ~length bp with substitutions and indels, staged."""
    from scrooge_tpu_torch.ops import pack

    text, pattern, plen = pair_codes(seed, B, length, rate)
    T = text.shape[1]
    tlen = np.full(B, T, np.int32)
    tw = pack.pack_2bit(torch.from_numpy(text)).to(dev)
    base = torch.arange(B, dtype=torch.int64, device=dev) * (tw.shape[1] * 16)
    maxw = -(-cfg.max_windows(int(plen.max())) // 32) * 32
    return maxw, (tw, base, torch.from_numpy(tlen).to(dev),
                  pack.pack_2bit(torch.from_numpy(pattern)).to(dev),
                  torch.from_numpy(plen).to(dev))


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
          early_termination=cfg.early_termination,
          B=int(args[4].shape[0]), maxw=maxw, kernel_ms=f"{ms:.3f}",
          plain_ms=f"{plain_ms:.3f}", max_abs_err=err, tolerance=0,
          failed_lanes=failed,
          fail_tb_lanes=int((got.failed & engine.FAIL_TB != 0).sum().item()))
    if err != 0:
        raise AssertionError(f"kernel and plain engine differ ({label})")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, plain=want)


def readback_check(label, cfg, stats, packed, qlens) -> dict:
    """The bytes a call read back beside its run entries, as phase-line
    fields: pairs go longest read first in tiles of cfg.batch_tile, each
    tile read back in api._lane_chunks, a chunk its most runs by its
    lanes (the runs of each pair in ``packed``); one byte an entry where
    31 < tb_limit <= 63, two above. Raises unless ``stats`` (one or
    several, strings and packed) hold exactly that, or when a uint8 call
    retried pairs (their packed runs come from CIGARs, so the entries
    cannot be counted). Token paths (tb_limit <= 31) are not checked."""
    from scrooge_tpu_torch import api

    if cfg.tb_limit <= 31:
        return {}
    per_entry = 1 if cfg.tb_limit <= api.U8_MAX_TB_LIMIT else 2
    if any(x.retried_pairs for x in stats):
        if per_entry == 1:
            raise AssertionError(f"{label}: pairs retried, the uint8 "
                                 "readback cannot be counted")
        return {"readback_per_entry": "not checked (retried pairs)"}
    runs = np.diff(packed.run_offsets)
    order = sorted(range(len(qlens)), key=lambda i: -qlens[i])
    entries = 0
    for t0 in range(0, len(order), cfg.batch_tile):
        lanes = runs[order[t0 : t0 + cfg.batch_tile]]
        for c0, c1 in api._lane_chunks(len(lanes)):
            entries += max(int(lanes[c0:c1].max(initial=0)), 1) * (c1 - c0)
    got = [x.readback_bytes for x in stats]
    if got != [per_entry * entries] * len(stats):
        raise AssertionError(f"{label}: read back {got} bytes for {entries} "
                             f"run entries at {per_entry} B an entry")
    return {"run_entries": entries, "readback_bytes": got[0],
            "readback_per_entry": per_entry}


def drive_path(label, cfg, ds, prepared, dev, nsample, ncigar):
    """align_reads through the public API, strings then packed, with the
    window kernels' and the token kernel's counts set to 0 just before
    and read just after; checks both outputs agree, ``nsample`` pairs (the
    longest read among them) equal pyref and ``ncigar`` CIGARs are valid
    (the bench's check_output), and that the token kernel built the
    tokens of every tile of both calls where the config takes tokens
    (tokens.supports) and launched nowhere else. Returns the counts,
    {kernel: {key: launches}}, and the string output."""
    import scrooge_tpu_torch as st
    from scrooge_tpu_torch import bench
    from scrooge_tpu_torch.ops import _cuda, tokens

    window_kernels = (_cuda.GENASM_WINDOWS1, _cuda.GENASM_WINDOWS,
                      _cuda.GENASM_WINDOWS_WIDE)
    for k in (*window_kernels, _cuda.GENASM_TOKENS):
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
    counts = {k: dict(k.counts) for k in (*window_kernels,
                                          _cuda.GENASM_TOKENS)}
    if sum(sum(counts[k].values()) for k in window_kernels) < 1:
        raise AssertionError(f"{label}: the path never launched the kernel")
    n = len(ds.reads)
    # one token launch a tile of each call (strings, packed)
    tiles = -(-sum(len(r.locations) for r in ds.reads) // cfg.batch_tile)
    want_tokens = 2 * tiles if tokens.supports(cfg) else 0
    token_launches = sum(counts[_cuda.GENASM_TOKENS].values())
    if token_launches != want_tokens:
        raise AssertionError(f"{label}: {token_launches} token kernel "
                             f"launches, {want_tokens} expected")
    npyref, ncigar = bench.check_output(ds.genome.content,
                                        bench.pair_reads(ds.reads), cfg,
                                        strs, packed, nsample, ncigar, label)
    readback = readback_check(label, cfg, (stats, pstats), packed,
                              [len(r.content) for r in ds.reads
                               for _ in r.locations])
    phase(label, W=cfg.W, K=cfg.K, O=cfg.O, pairs=n,
          launches=json.dumps({k.source: c for k, c in counts.items()}),
          token_launches=token_launches, retried_pairs=stats.retried_pairs,
          pyref_exact=npyref, valid_cigars=ncigar,
          wall_s=f"{wall:.3f}", aligns_per_s=f"{n / wall:.1f}",
          packed_wall_s=f"{pwall:.3f}",
          packed_aligns_per_s=f"{n / pwall:.1f}", **readback,
          breakdown=repr(stats.breakdown()),
          packed_breakdown=repr(pstats.breakdown()))
    return counts, strs


def pairs_path(cfg, seed, dev, B=512, length=1000, nsample=8, ncigar=128):
    """Phase 3's align_pairs: B pairs of ~length bp (pair_codes) as
    strings through the public API on the card, strings then packed, the
    window kernels' counts set to 0 just before and read just after: the
    two outputs must agree, ``nsample`` pairs equal pyref, ``ncigar``
    CIGARs be valid and the readback hold one byte a run entry where
    31 < tb_limit <= 63 (readback_check). Returns the launches."""
    import scrooge_tpu_torch as st
    from scrooge_tpu_torch import pyref
    from scrooge_tpu_torch.bench import check_sample, packed_cigars
    from scrooge_tpu_torch.cigar import is_valid_cigar
    from scrooge_tpu_torch.ops import _cuda

    text, pattern, plen = pair_codes(seed, B, length, 0.05)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    texts = [acgt[t].tobytes().decode() for t in text]
    queries = [acgt[p[:n]].tobytes().decode() for p, n in zip(pattern, plen)]
    for k in _cuda.KERNELS:
        k.counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strs, stats = st.align_pairs(texts, queries, cfg, return_stats=True,
                                 device=dev)
    wall = time.perf_counter() - t0
    packed, pstats = st.align_pairs(texts, queries, cfg, return_stats=True,
                                    return_packed=True, device=dev)
    counts = {k.source: dict(k.counts) for k in _cuda.KERNELS if k.counts}
    label = f"pairs-w{cfg.W}"
    if [a.cigar for a in strs] != packed_cigars(packed) or not np.array_equal(
            np.array([a.edit_distance for a in strs]), packed.edit_distances):
        raise AssertionError(f"{label}: strings and packed output disagree")
    sample, cigars = check_sample([len(q) for q in queries], nsample, ncigar)
    for i in sample:
        want = pyref.genasm(pyref.encode(texts[i]), pyref.encode(queries[i]),
                            cfg)
        if (strs[i].edit_distance, strs[i].cigar) != want:
            raise AssertionError(f"{label}: pair {i} differs from pyref")
    for i in cigars:
        if not is_valid_cigar(strs[i].cigar, strs[i].edit_distance, texts[i],
                              queries[i], 0):
            raise AssertionError(f"{label}: pair {i} has an invalid CIGAR")
    readback = readback_check(label, cfg, (stats, pstats), packed,
                              [len(q) for q in queries])
    phase(label, W=cfg.W, K=cfg.K, O=cfg.O, tb_limit=cfg.tb_limit, pairs=B,
          launches=json.dumps(counts), retried_pairs=stats.retried_pairs,
          pyref_exact=len(sample), valid_cigars=len(cigars),
          wall_s=f"{wall:.3f}", **readback,
          breakdown=repr(stats.breakdown()),
          packed_breakdown=repr(pstats.breakdown()))
    if sum(sum(c.values()) for c in counts.values()) < 2:
        raise AssertionError(f"{label}: launches {counts}")
    return counts


def kernel_only(label, staged, n):
    from scrooge_tpu_torch.profiling import kernel_time

    samples = kernel_time.engine_ms(staged, reps=3, groups=3)
    rates = sorted(n * 1e3 / ms for ms in samples)
    phase(label, tile=n, ms=" ".join(f"{x:.3f}" for x in samples),
          aligns_per_s=f"{rates[1]:.1f}", min=f"{rates[0]:.1f}",
          max=f"{rates[-1]:.1f}")


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
    from scrooge_tpu_torch.profiling.model import fill_bound
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


def file_path(ds, main_strs, small, dev, tmp):
    """Phase 9: the CLIs on the card, from files (see the docstring)."""
    import scrooge_tpu_torch as st
    from scrooge_tpu_torch import io as sio
    from scrooge_tpu_torch.cigar import affine_score, edits_in_cigar
    from scrooge_tpu_torch.cli import baseline_cli, tests_cli
    from scrooge_tpu_torch.ops import _cuda
    from scrooge_tpu_torch.profiling.pipeline import trace_shares
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
        os.path.join(trace_dir, "trace.json"), "genasm_windows1_kernel")
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


def wide_windows(ds, prepared, small, sprep, dev, ops_rate, tmp, paths):
    """Phase 10 (see the docstring): returns the kernels-line entries of
    the wide kernel, at G = 8 (NW=8), 16 (NW=16) and 32 (NW=32), and the
    W=512 tile as (cfg, staged, plain result); adds each path's (cfg,
    dataset, prepared genome, strings) to ``paths`` under its NW."""
    import scrooge_tpu_torch as st
    from scrooge_tpu_torch.ops import _cuda, engine
    from scrooge_tpu_torch.profiling import kernel_time, sweep
    from scrooge_tpu_torch.profiling.model import r_floor, window_bound
    from scrooge_tpu_torch.utils.simulate import SimulatedDataset

    wide = _cuda.GENASM_WINDOWS_WIDE
    ptxas = ptxas_summary(wide.build_log)
    phase("wide-ptxas", source=WIDE_SOURCE, ptxas=repr(ptxas))
    for g in (4, 8, 16, 32):
        for et in ("true", "false"):
            if not re.search(rf"genasm_windows_wide_kernel<{g}, {et}>: \d+ "
                             "regs, 0 B spill", ptxas):
                raise AssertionError(f"the wide kernel at G = {g}, ET "
                                     f"{et}: {ptxas}")
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
    counts, strs = drive_path("w512-path", cfg, sub, prepared, dev, 4, 128)
    paths[8] = (cfg, sub, prepared, strs)
    w512 = (cfg, staged, tile["plain"])
    launches = counts[wide].get(8, 0)
    if launches < 1 or any(counts[k] for k in counts if k is not wide):
        raise AssertionError(f"the W=512 path's launches: {counts}")
    kernel_only("w512-kernel-only", staged, len(sub.reads))
    bound_ms, bound_by, detail = window_bound(cfg, staged[1], staged[2],
                                              tile["plain"], ops_rate)
    r_bytes, r_ms = r_floor(cfg, tile["plain"])
    phase("bound", kernel="genasm_windows_wide[NW=8]", W=cfg.W,
          bound_ms=f"{bound_ms:.6f}", bound_by=bound_by, **detail,
          r_bytes_floor=r_bytes, r_floor_ms=f"{r_ms:.6f}")
    kernels = [{"name": "genasm_windows_wide[NW=8]", "route": "cuda",
                "source": WIDE_SOURCE, "replaces": WIDE_REPLACES,
                "launches": launches, "max_abs_err": tile["max_abs_err"],
                "ms": tile["ms"], "plain_ms": tile["plain_ms"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
                "shape": f"W=512 K=512 O=257 B={staged[3]}"}]

    # G = 16 and 32: align_reads on 64 of phase 7's 2 kbp reads
    sub = SimulatedDataset(genome=small.genome, reads=small.reads[:64])
    for nw, (W, K, O) in ((16, (1024, 1024, 513)), (32, (2048, 2048, 1025))):
        # batch_tile comes in 128s: one tile of the 64 reads
        c = st.AlignConfig(W=W, K=K, O=O, batch_tile=128)
        sst = kernel_time.stage_mapped(sprep, sub.reads, c, dev)
        cmp = compare(c, sst[1], sst[2], "64x2kbp path tile")
        cnt, strs = drive_path(f"wide-path-w{W}", c, sub, sprep, dev, 2, 32)
        paths[nw] = (c, sub, sprep, strs)
        n_launch = cnt[wide].get(nw, 0)
        if n_launch < 1 or any(cnt[k] for k in cnt if k is not wide):
            raise AssertionError(f"the W={W} path's launches: {cnt}")
        b_ms, b_by, det = window_bound(c, sst[1], sst[2], cmp["plain"],
                                       ops_rate)
        phase("bound", kernel=f"genasm_windows_wide[NW={nw}]", W=W,
              bound_ms=f"{b_ms:.6f}", bound_by=b_by, **det)
        kernels.append({
            "name": f"genasm_windows_wide[NW={nw}]", "route": "cuda",
            "source": WIDE_SOURCE, "replaces": WIDE_REPLACES,
            "launches": n_launch, "max_abs_err": cmp["max_abs_err"],
            "ms": cmp["ms"], "plain_ms": cmp["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": f"W={W} K={K} O={O} B={sst[3]}"})

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
    want = {("256", "genasm_windows_wide"), ("512", "genasm_windows_wide")}
    got = {(r["W"], r["early termination"], r["engine"]) for r in rows
           if float(r["aligns/second"]) > 0}
    if rc != 0 or got != {(w, et, e) for w, e in want
                          for et in ("False", "True")}:
        raise AssertionError(f"sweep rows: {rows}")
    # early termination off fills every row up to K: each W's ET=False
    # row must be slower than its ET=True twin
    rate = {(r["W"], r["early termination"]): float(r["aligns/second"])
            for r in rows}
    for w, _ in sorted(want):
        if not rate[(w, "False")] < rate[(w, "True")]:
            raise AssertionError(f"sweep at W={w}: ET off "
                                 f"{rate[(w, 'False')]} aligns/s is not "
                                 f"slower than ET on {rate[(w, 'True')]}")
    phase("sweep-et", **{f"W{w}_off_over_on":
                         f"{rate[(w, 'False')] / rate[(w, 'True')]:.4f}"
                         for w, _ in sorted(want)})
    return kernels, w512


def window_entry(cfg, nw) -> dict:
    """The kernels-line name, source and replaced kernel of the window
    kernel instantiation the config launches: genasm_windows1[NW=1],
    genasm_windows[NW=2..3] or genasm_windows_wide[NW=4/8/16/32] (its G),
    with ',ET=off' without early termination."""
    from scrooge_tpu_torch.ops import _cuda, engine

    base, source, replaces = {
        _cuda.GENASM_WINDOWS1: ("genasm_windows1", WINDOWS1_SOURCE,
                                WINDOWS_REPLACES),
        _cuda.GENASM_WINDOWS: ("genasm_windows", WINDOWS_SOURCE,
                               WINDOWS_REPLACES),
        _cuda.GENASM_WINDOWS_WIDE: ("genasm_windows_wide", WIDE_SOURCE,
                                    WIDE_REPLACES)}[engine.window_kernel(cfg)]
    if nw == 4:  # the wide kernel in the Pallas kernel's place
        replaces = WINDOWS_REPLACES
    et = "" if cfg.early_termination else ",ET=off"
    return {"name": f"{base}[NW={nw}{et}]", "route": "cuda",
            "source": source, "replaces": replaces}


def et_off(tiles, paths, dev, ops_rate):
    """Phase 13: the window kernels without early termination (the
    instantiations with engine.ET_OFF in their key). Each against its
    plain version with ET off at max abs err 0: 512 x 1 kbp at W = 64,
    128, 192 and 256 (K = W), the unrelated pairs of phase 3, and 64 x 2
    kbp at W = 320, 512, 1024 and 2048 at a reduced K; then ET on against
    ET off on ``tiles`` (name -> (cfg, staged, plain ET-on result)), in
    turns, CUDA events, each beside its bound: the ET-off bound counts
    K+1 rows of every window from the ET-on plain run's count of one
    row's cells (work[2]), so plain never runs with ET off on a full
    tile; then each path of ``paths`` (NW -> cfg, dataset, prepared
    genome, ET-on strings) again through align_reads with ET off, the
    counts set to 0 just before: its output must equal the ET-on path's
    and only the ET-off instantiation may launch. Returns the
    kernels-line entries of the ET-off instantiations."""
    import dataclasses

    import scrooge_tpu_torch as st
    from scrooge_tpu_torch.ops import _cuda, engine
    from scrooge_tpu_torch.profiling import kernel_time, model

    t_phase = time.perf_counter()
    no_et = lambda c: dataclasses.replace(c, early_termination=False)
    checks = {}  # NW -> (cfg, maxw, args, compare result) of its shape
    for W, K, O in ((64, 64, 33), (128, 128, 65), (192, 192, 97),
                    (256, 256, 129)):
        cfg = st.AlignConfig(W=W, K=K, O=O, early_termination=False)
        maxw, args = random_pairs(cfg, W, dev)
        checks[engine.num_words(W)] = (cfg, maxw, args, compare(
            cfg, maxw, args, "512x1kbp"))
    for W, K, O in ((64, 64, 33), (64, 16, 33), (128, 128, 65),
                    (128, 16, 65)):
        cfg = st.AlignConfig(W=W, K=K, O=O, early_termination=False)
        maxw, args = unrelated_pairs(cfg, 100 + K, dev)
        want = compare(cfg, maxw, args, "512x1kbp-unrelated")["plain"]
        fail_tb = int((want.failed & engine.FAIL_TB != 0).sum().item())
        if (K == 16) != (fail_tb > 0):
            raise AssertionError(f"unrelated pairs at W={W} K={K} ET off: "
                                 f"{fail_tb} FAIL_TB lanes")
    for (W, K, O), nw in (((320, 64, 161), None), ((512, 64, 257), 8),
                          ((1024, 128, 513), 16), ((2048, 192, 1025), 32)):
        cfg = st.AlignConfig(W=W, K=K, O=O, early_termination=False)
        maxw, args = random_pairs(cfg, W + O, dev, B=64, length=2000)
        got = compare(cfg, maxw, args, "64x2kbp")
        if nw:
            checks[nw] = (cfg, maxw, args, got)

    # ET on against ET off, in turns (on, off, off, on)
    for name, (cfg, staged, plain) in tiles.items():
        off = (no_et(cfg),) + tuple(staged[1:])
        kern = engine.window_kernel(cfg)
        keys = {True: engine.kernel_key(cfg), False: engine.kernel_key(off[0])}
        kern.counts.clear()
        torch.cuda.synchronize()
        ms = {True: [], False: []}
        for et in (True, False, False, True):
            ms[et] += kernel_time.engine_ms(staged if et else off, reps=3,
                                            groups=2)
        bound = {et: model.window_bound(c, staged[1], staged[2], plain,
                                        ops_rate)
                 for et, c in ((True, cfg), (False, off[0]))}
        med = {et: sorted(v)[len(v) // 2] for et, v in ms.items()}
        phase("et-ablation", shape=name, W=cfg.W, K=cfg.K, O=cfg.O,
              B=staged[3], kernel=kern.source,
              ms_on=" ".join(f"{x:.3f}" for x in ms[True]),
              ms_off=" ".join(f"{x:.3f}" for x in ms[False]),
              off_over_on=f"{med[False] / med[True]:.4f}",
              bound_ms_on=f"{bound[True][0]:.6f}",
              bound_ms_off=f"{bound[False][0]:.6f}",
              bound_by_off=bound[False][1],
              bound_off_over_on=f"{bound[False][0] / bound[True][0]:.4f}",
              cells_on=bound[True][2]["cells"],
              cells_off=bound[False][2]["cells"],
              bound_method="ET off: (K+1) x one row's cells over the "
                           "windows (work[2]) of the ET-on plain run",
              launches_on=kern.counts[keys[True]],
              launches_off=kern.counts[keys[False]])
        if not (kern.counts[keys[True]] and kern.counts[keys[False]]):
            raise AssertionError(f"{name}: launches {dict(kern.counts)}")
        if not med[False] > med[True]:
            raise AssertionError(f"{name}: ET off is not slower than on")

    # every path again with ET off, through the public API
    window_kernels = (_cuda.GENASM_WINDOWS1, _cuda.GENASM_WINDOWS,
                      _cuda.GENASM_WINDOWS_WIDE)
    entries = []
    for nw, (cfg, ds, prepared, want) in sorted(paths.items()):
        cfg = no_et(cfg)
        kern, key = engine.window_kernel(cfg), engine.kernel_key(cfg)
        for k in window_kernels:
            k.counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        strs = st.align_reads(prepared, ds.reads, cfg, device=dev)
        wall = time.perf_counter() - t0
        counts = {k.source: dict(k.counts) for k in window_kernels
                  if k.counts}
        launches = kern.counts[key]
        equal = sum((a.edit_distance, a.cigar) == (b.edit_distance, b.cigar)
                    for a, b in zip(strs, want))
        phase("et-off-path", W=cfg.W, K=cfg.K, O=cfg.O, pairs=len(strs),
              wall_s=f"{wall:.3f}", equal_to_et_on=equal,
              launches=json.dumps(counts))
        if equal != len(want) or len(strs) != len(want):
            raise AssertionError(f"ET off at W={cfg.W}: {len(want) - equal}"
                                 " alignments differ from ET on")
        if launches < 1 or counts != {kern.source: {key: launches}}:
            raise AssertionError(f"ET off at W={cfg.W}: launches {counts}")
        c, maxw, args, cmp = checks[nw]
        bound_ms, bound_by, detail = model.window_bound(c, maxw, args,
                                                        cmp["plain"],
                                                        ops_rate)
        entry = window_entry(c, nw)
        phase("bound", kernel=entry["name"], W=c.W, K=c.K,
              bound_ms=f"{bound_ms:.6f}", bound_by=bound_by, **detail)
        entries.append({
            **entry, "launches": launches, "max_abs_err": cmp["max_abs_err"],
            "ms": cmp["ms"], "plain_ms": cmp["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": f"W={c.W} K={c.K} O={c.O} B={int(args[4].shape[0])}"})
    phase("et-off", seconds=f"{time.perf_counter() - t_phase:.2f}")
    return entries


def mesh_path(ds, prepared, main_strs, cfg):
    """Phase 11, part 1: align_reads on a mesh (see the docstring)."""
    import scrooge_tpu_torch as st
    from scrooge_tpu_torch.bench import packed_cigars
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
    strs_tokens = _cuda.GENASM_TOKENS.counts[0]
    t0 = time.perf_counter()
    packed, pstats = st.align_reads(prepared, ds.reads, cfg,
                                    return_stats=True, return_packed=True,
                                    device=mesh)
    pwall = time.perf_counter() - t0
    counts = {k.source: dict(k.counts) for k in (one, *others)}
    # the token kernel once a shard of a tile, in each of the three calls
    tiles = -(-sum(len(r.locations) for r in ds.reads) // cfg.batch_tile)
    token_launches = sum(_cuda.GENASM_TOKENS.counts.values())
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
          launches=json.dumps(counts), token_launches=token_launches,
          retried_pairs=stats.retried_pairs,
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
            < 3 * len(mesh) or any(counts[k.source] for k in others)
            or token_launches != 3 * tiles * len(mesh)
            or strs_tokens != 2 * tiles * len(mesh)):
        raise AssertionError(f"mesh path launches: {counts}, "
                             f"{token_launches} of the token kernel")


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


def pipeline_path(ds, prepared, single, tmp):
    """Phase 12 (see the docstring): align_reads in 16 tiles."""
    import scrooge_tpu_torch as st
    from scrooge_tpu_torch import api
    from scrooge_tpu_torch.bench import packed_cigars
    from scrooge_tpu_torch.ops import _cuda, tokens
    from scrooge_tpu_torch.profiling import pipeline

    # (W, K, O), device, threads that decode the CIGARs (None: the API's
    # DECODE_THREADS; 1: in order, to weigh the pool against it)
    runs = [((64, 64, 33), "cuda", None), ((64, 64, 33), "cuda", 1),
            ((128, 128, 65), "cuda", None),
            ((64, 64, 33), ["cuda:0", "cuda:0"], None)]
    threads = api.DECODE_THREADS
    for (W, K, O), dev, decode_threads in runs:
        cfg = st.AlignConfig(W=W, K=K, O=O, batch_tile=1024)
        want = single[W]
        api.DECODE_THREADS = decode_threads or threads
        mode_stats = []
        for mode, packed in (("strings", False), ("packed", True)):
            for k in _cuda.KERNELS:
                k.counts.clear()
            out, stats, wall = pipeline.call(prepared, ds.reads, cfg, dev,
                                             packed)
            launches = {k.source: dict(k.counts) for k in _cuda.KERNELS
                        if k.counts}
            mode_stats.append(stats)
            # the uint8 readback (W=128), checked once both modes ran
            readback = (readback_check(f"pipeline W={W}", cfg, mode_stats,
                                       out, [len(r.content) for r in ds.reads])
                        if packed and isinstance(dev, str) else {})
            got = (list(zip(out.edit_distances.tolist(), packed_cigars(out)))
                   if packed else [(a.edit_distance, a.cigar) for a in out])
            equal = sum(g == (a.edit_distance, a.cigar)
                        for g, a in zip(got, want))
            _, (n_kernels, kernel_ms, busy, span_ms) = pipeline.traced_call(
                prepared, ds.reads, cfg, dev, packed,
                os.path.join(tmp, "trace.json"))
            tiles = -(-len(ds.reads) // cfg.batch_tile)
            phase("pipeline", W=W, K=K, O=O, mode=mode,
                  device=repr(dev if isinstance(dev, str)
                              else [str(d) for d in dev]),
                  decode_threads=api.DECODE_THREADS,
                  pairs=len(got), tiles=tiles,
                  equal_to_single_tile=equal, wall_s=f"{wall:.3f}",
                  aligns_per_s=f"{len(got) / wall:.1f}",
                  launches=json.dumps(launches), **readback,
                  breakdown=repr(stats.breakdown()),
                  window_kernels_in_trace=n_kernels,
                  window_kernel_ms_in_trace=f"{kernel_ms:.3f}",
                  traced_call_ms=f"{span_ms:.3f}",
                  device_busy_share=f"{busy:.4f}",
                  device_idle_share=f"{1 - busy:.4f}")
            if equal != len(want) or len(got) != len(want):
                raise AssertionError(f"pipeline W={W} {mode} on {dev}: "
                                     f"{len(want) - equal} alignments "
                                     "differ from the single tile's")
            shards = 1 if isinstance(dev, str) else len(dev)
            # the window kernels at least once a shard of a tile; the
            # token kernel exactly once where the config takes tokens
            token_launches = sum(launches.pop(
                _cuda.GENASM_TOKENS.source, {}).values())
            want_tokens = tiles * shards if tokens.supports(cfg) else 0
            if (sum(sum(c.values()) for c in launches.values())
                    < tiles * shards or n_kernels < 1
                    or token_launches != want_tokens):
                raise AssertionError(
                    f"pipeline W={W} {mode}: launches {launches}, "
                    f"{token_launches} of the token kernel "
                    f"({want_tokens} expected), {n_kernels} traced")
    api.DECODE_THREADS = threads


# phase 14: the bench at its defaults, then at the short-read point
BENCH_RUNS = (("long", {}),
              ("short", {"BENCH_W": "32", "BENCH_O": "17",
                         "BENCH_READ_LEN": "150"}))


def bench_path():
    """Phase 14 (see the docstring): ``python -m scrooge_tpu_torch.bench``
    as a user runs it, in a process of its own whose kernel counts start
    at 0; its stderr lines (the breakdowns, the kernel tile, the launches
    of each pass) are printed after its phase line."""
    from scrooge_tpu_torch import bench
    from scrooge_tpu_torch.ops import _cuda

    for point, env in BENCH_RUNS:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "scrooge_tpu_torch.bench"],
                             cwd=ROOT, env={**os.environ, **env},
                             capture_output=True, text=True, timeout=400)
        secs = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"bench {point} exited {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
        line = json.loads(out.stdout.strip().splitlines()[-1])
        want = (*bench.KEYS, *bench.CARD_KEYS,
                *(bench.LONG_READ_KEYS if point == "long" else ()))
        missing = [k for k in want if k not in line]
        launches = json.loads(next(
            ln for ln in out.stderr.splitlines()
            if ln.startswith("# launches "))[len("# launches "):])
        walls = re.search(r" wall=([\d.]+)s packed_wall=([\d.]+)s ",
                          out.stderr)
        phase("bench", point=point, env=json.dumps(env),
              seconds=f"{secs:.2f}",
              strings_wall_s=walls.group(1) if walls else None,
              packed_wall_s=walls.group(2) if walls else None,
              line=json.dumps(line), launches=json.dumps(launches))
        for ln in out.stderr.splitlines():
            print(f"  bench[{point}] {ln}", flush=True)
        if missing or not walls:
            raise AssertionError(f"bench {point}: no {missing} in its line "
                                 "or no walls on its stderr")
        for run in ("end_to_end", "kernel_only", "staged"):
            if launches.get(run, {}).get(_cuda.GENASM_WINDOWS1.source,
                                         {}).get("1", 0) < 1:
                raise AssertionError(f"bench {point}: its {run} pass never "
                                     "launched genasm_windows1.cu")


ASSEMBLY_REPS = 5


def assembly_path(ds, prepared, main_strs, dev):
    """Phase 15: api._assemble_packed_parts on the bench's shape, 32,768
    pairs of 10 kbp (phase 4's reads twice) in two tiles of 16,384 at
    W=64, on the card's host. The parts come from one align_reads call
    with return_packed (the function wrapped to keep its arguments): in
    the API's own order, the length sort's permutation, and relabelled so
    that each tile's lanes are the next pairs (the identity order). Each
    is timed ASSEMBLY_REPS times and must equal phase 4's strings for its
    pairs; the identity order must not scatter, the permuted one scatter
    once a tile."""
    import scrooge_tpu_torch as st
    from scrooge_tpu_torch import api, native
    from scrooge_tpu_torch.bench import packed_cigars

    reads = list(ds.reads) * 2
    cfg = st.AlignConfig(W=64, K=64, O=33, batch_tile=16384)
    real, kept = api._assemble_packed_parts, []

    def keep(n, parts, results):
        kept.append((n, parts, results))
        return real(n, parts, results)

    api._assemble_packed_parts = keep
    try:
        t0 = time.perf_counter()
        st.align_reads(prepared, reads, cfg, return_packed=True, device=dev)
        call_s = time.perf_counter() - t0
    finally:
        api._assemble_packed_parts = real
    n, parts, results = kept[0]
    want = [(a.edit_distance, a.cigar) for a in list(main_strs) * 2]
    lane_pairs = [i for part in parts for i in part[2]]
    ident, pos = [], 0
    for flat, offs, idxs, eds, failed in parts:
        ident.append((flat, offs, list(range(pos, pos + len(idxs))), eds,
                      failed))
        pos += len(idxs)
    orders = {"identity": (ident, [results[i] for i in lane_pairs],
                           [want[i] for i in lane_pairs]),
              "permuted": (parts, results, want)}
    scatter = native.scatter_runs
    for order, (ps, rs, expect) in orders.items():
        calls = []
        native.scatter_runs = lambda *a: calls.append(1) or scatter(*a)
        try:
            ms = []
            for _ in range(ASSEMBLY_REPS):
                t0 = time.perf_counter()
                out = real(n, ps, rs)
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            native.scatter_runs = scatter
        got = list(zip(out.edit_distances.tolist(), packed_cigars(out)))
        equal = sum(g == w for g, w in zip(got, expect))
        phase("assembly", order=order, pairs=n, tiles=len(ps),
              runs=len(out.runs), runs_mb=f"{out.runs.nbytes / 1e6:.1f}",
              ms=" ".join(f"{x:.3f}" for x in ms),
              scatter_calls=len(calls) // ASSEMBLY_REPS,
              equal_to_strings=equal, call_s=f"{call_s:.3f}")
        if equal != n or len(got) != n:
            raise AssertionError(f"assembly ({order}): {n - equal} of {n} "
                                 "pairs differ from the strings")
        if len(calls) != (0 if order == "identity"
                          else len(ps) * ASSEMBLY_REPS):
            raise AssertionError(f"assembly ({order}): {len(calls)} scatters")


TOKENS_SOURCE = "scrooge_tpu_torch/csrc/genasm_tokens.cu"
TOKENS_REPLACES = ("none: scrooge_tpu/ops/tokens.py:41-148 compact_tokenize "
                   "+ compact_tokens (XLA)")
TOKENS_REPS = 5
HBM_BYTES_PER_S = 3.35e12


def chained_tile(dev, seed=2**31 + 29, n_reads=560, B=1024):
    """One tile of w64_chained's shape: PBSIM2 CLR reads of 10 kbp at 95 %
    (portbench.generate), each with its true position and Poisson(1)
    decoys on a 20 Mbp random genome, the B longest pairs at 64/64/33,
    staged as align_reads stages them. Returns (cfg, windows, the
    engine's arguments, the window kernel's BatchResult on them, decoys
    drawn)."""
    import scrooge_tpu_torch as st
    from portbench import generate
    from scrooge_tpu_torch import api
    from scrooge_tpu_torch.ops import engine, pack

    cfg = st.AlignConfig(W=64, K=64, O=33)
    gen = generate.generator(seed, dev)
    genome, gcodes = generate.make_genome([20_000_000], gen, dev)
    rs = generate.make_reads(genome, gcodes, n_reads, 10_000, 0.95,
                             (6, 55, 39), 1.0, gen)
    pairs = sorted(((loc.start_in_reference, r) for r in rs.reads
                    for loc in r.locations),
                   key=lambda p: -len(p[1].content))[:B]
    glen = len(genome.content)
    longest = len(pairs[0][1].content)
    maxw = api._maxw(cfg, longest)
    starts = np.array([s for s, _ in pairs], np.int64)
    tlen = np.minimum(glen - starts, maxw * cfg.tb_limit + cfg.W)
    plen = np.array([len(r.content) for _, r in pairs], np.int32)
    pw = pack.to_device(pack.encode_pack_host([r.content for _, r in pairs],
                                              longest), dev)
    words = st.prepare_genome(genome).device_words(dev)
    args = (words, torch.from_numpy(starts).to(dev),
            torch.from_numpy(tlen.astype(np.int32)).to(dev), pw,
            torch.from_numpy(plen).to(dev))
    res = engine.align_windows(cfg, maxw, *args)
    decoys = sum(len(r.locations) - 1 for r in rs.reads)
    return cfg, maxw, args, res, decoys


def tokens_path(dev, main_launches: int) -> dict:
    """Phase 16: the token kernel on w64_chained's tile against the torch
    chain it replaces on the card (compact_tokenize, the token totals'
    sync, compact_tokens), in turns, CUDA events, TOKENS_REPS each: equal
    bytes over every row, both times, the device memory each adds to the
    tile's, and the kernel's bound (bytes of counts, of the entries'
    sectors that hold runs, of the output rows and totals, over the HBM
    rate). Returns the kernels-line entry, whose launches are
    ``main_launches``, the main path's (phase 4)."""
    from scrooge_tpu_torch.ops import compact, tokens

    cfg, _, _, res, decoys = chained_tile(dev)
    meta = compact.batch_meta(res).cpu().numpy()
    B = meta.shape[1]
    cap = max(int(meta[1].max()), 1)
    ne = max(int(meta[3].max()), 1)
    wcap = max(int(meta[4].max()), 1)
    ent, cnt = res.entries[:wcap], res.counts[:wcap]

    def chain():
        toks, _, tot = tokens.compact_tokenize(ent, cnt, cap, ne)
        tot = tot.cpu()
        return tokens.compact_tokens(toks, max(int(tot.max()), 1)), tot

    out, tot = tokens.lane_tokens(ent, cnt, cap)  # build and warm up
    want, want_tot = chain()
    torch.cuda.synchronize()
    capT = want.shape[1]
    err = int((tot.cpu() != want_tot).sum()) + int(
        (out[:, :capT] != want).sum()) + int(out[:, capT:].any())
    ms, chain_ms, peak = [], [], {}
    base = torch.cuda.memory_allocated()
    for _ in range(TOKENS_REPS):
        for label, fn, times in (("kernel", lambda: tokens.lane_tokens(
                ent, cnt, cap), ms), ("chain", chain, chain_ms)):
            torch.cuda.reset_peak_memory_stats()
            _, t = timed(fn)
            times.append(t)
            peak[label] = torch.cuda.max_memory_allocated() - base
    counts = cnt.cpu().numpy().clip(0, ent.shape[1])
    # a 32-byte sector holds 16 lanes' int16 runs of one (window, row)
    groups = np.pad(counts, ((0, 0), (0, -B % 16))).reshape(wcap, -1, 16)
    sectors = int(groups.max(2).sum())
    nbytes = {"counts": 4 * wcap * B, "entry_sectors": 32 * sectors,
              "out": B * 2 * cap + 4 * B}
    bound_ms = sum(nbytes.values()) / HBM_BYTES_PER_S * 1e3
    runs = int(meta[1][meta[2] == 0].sum())
    phase("tokens", shape=f"W={cfg.W} K={cfg.K} O={cfg.O} B={B}",
          decoys=decoys, wcap=wcap, ne=ne, cap=cap, capT=capT,
          runs_per_pair=f"{runs / B:.2f}", tokens=int(want_tot.sum()),
          kernel_ms=" ".join(f"{t:.3f}" for t in ms),
          chain_ms=" ".join(f"{t:.3f}" for t in chain_ms),
          kernel_peak_bytes=peak["kernel"], chain_peak_bytes=peak["chain"],
          bound_ms=f"{bound_ms:.6f}", bytes=json.dumps(nbytes),
          max_abs_err=err, main_path_launches=main_launches)
    if err != 0:
        raise AssertionError("the token kernel and the torch chain differ")
    return {"name": "genasm_tokens", "route": "cuda",
            "source": TOKENS_SOURCE, "replaces": TOKENS_REPLACES,
            "launches": main_launches, "max_abs_err": err,
            "ms": float(np.median(ms)),
            "plain_ms": float(np.median(chain_ms)),
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "shape": f"W={cfg.W} K={cfg.K} O={cfg.O} B={B} wcap={wcap}"}


def windows1_path(dev, ops_rate, main_launches: int, against=()) -> dict:
    """Phase 17: the one-word kernel on w64_chained's tile (chained_tile),
    its output and row counters held to the plain version's, its bound
    and row fill beside it; then the instantiation without early
    termination against the same output. Each file in ``against``
    (another version of the source, such as the parent's) is held to the
    same outputs, ET on and off, and timed with the kernel in turns
    (window_lab.measure). Returns the kernels-line entry, whose launches
    are ``main_launches``, the main path's (phase 4)."""
    from scrooge_tpu_torch.ops import engine
    from scrooge_tpu_torch.profiling import model
    from scrooge_tpu_torch.tools import window_lab

    cfg, maxw, args, _, decoys = chained_tile(dev)
    B = int(args[4].shape[0])
    cmp = compare(cfg, maxw, args, "w64_chained tile")
    plain = cmp["plain"]
    slots, work = (int(x) for x in plain.rows)
    bound_ms, bound_by, detail = model.window_bound(cfg, maxw, args, plain,
                                                    ops_rate)
    phase("windows1-chained", W=cfg.W, K=cfg.K, O=cfg.O, B=B,
          decoys=decoys, maxw=maxw, row_slots=slots, row_work=work,
          row_fill=f"{work / slots:.4f}", kernel_ms=f"{cmp['ms']:.3f}",
          bound_ms=f"{bound_ms:.6f}", bound_by=bound_by, **detail)
    off = dataclasses.replace(cfg, early_termination=False)
    got, off_ms = timed(engine.align_windows, off, maxw, *args)
    err = max_abs_diff(got._replace(rows=None), plain)
    phase("windows1-chained-etoff", kernel_ms=f"{off_ms:.3f}",
          row_slots=int(got.rows[0]), max_abs_err=err)
    if err:
        raise AssertionError("the ET-off outputs on the w64_chained tile "
                             "differ from the ET-on plain version's")
    for k, file in enumerate(against, 1):
        kern = window_lab.variant_kernel("full", path=file)
        res, _ = window_lab.launch(kern, off, maxw, args, 0,
                                   window_lab.thread_pair_r_words(off, B))
        err = max_abs_diff(res, plain)
        phase("windows1-against-etoff", file=file, max_abs_err=err)
        if err:
            raise AssertionError(f"{file}: ET-off outputs differ")
    rows = (window_lab.measure(("full",), (cfg, maxw, args, B),
                               against=against) if against else [])
    for r in rows:
        phase("windows1-turns", variant=r["variant"],
              samples_ms=" ".join(f"{x:.3f}" for x in r["samples"]),
              median_ms=f"{r['median_ms']:.3f}", same=r["same"],
              ptxas=repr(r["ptxas"]))
        if not r["same"]:
            raise AssertionError(f"{r['variant']}: output differs from the "
                                 "engine's on the w64_chained tile")
    return {"name": "genasm_windows1[NW=1,w64_chained]", "route": "cuda",
            "source": WINDOWS1_SOURCE, "replaces": WINDOWS_REPLACES,
            "launches": main_launches,
            "max_abs_err": cmp["max_abs_err"], "ms": cmp["ms"],
            "plain_ms": cmp["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shape": f"W={cfg.W} K={cfg.K} O={cfg.O} B={B} chained"}


def main(against=()) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import scrooge_tpu_torch as st
    from scrooge_tpu_torch.ops import _cuda, engine
    from scrooge_tpu_torch.profiling import kernel_time, model
    from scrooge_tpu_torch.utils.simulate import (SimulatedDataset,
                                                  simulate_dataset)

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 1. toolchain ----
    try:
        import triton  # noqa: F401

        has_triton = True
    except ImportError:
        has_triton = False
    card = nvidia_smi("name,power.limit")
    ops_rate = model.int32_ops_per_s()
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
    # 96/96/49 (tb_limit 47) through align_pairs: uint8 runs read back
    c96 = st.AlignConfig(W=96, K=96, O=49)
    if pairs_path(c96, 96, dev).get(_cuda.GENASM_WINDOWS.source, {}).get(
            2, 0) < 2:
        raise AssertionError("align_pairs at 96/96/49 did not launch "
                             "genasm_windows.cu at NW=2")

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
    # NW -> (cfg, dataset, prepared genome, strings) of each path with
    # early termination, which phase 13 runs again without it
    paths = {}

    # ---- 4. main path ----
    counts = {}
    counts[1], main_strs = drive_path("main-path", cfg, ds, prepared, dev, 16,
                                      512)
    paths[1] = (cfg, ds, prepared, main_strs)
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
    counts[2], wide_strs = drive_path("wide-path", wcfg, ds, prepared, dev,
                                      16, 512)
    paths[2] = (wcfg, ds, prepared, wide_strs)
    kernel_only("wide-kernel-only", wstaged, len(ds.reads))
    small = simulate_dataset(genome_len=200_000, num_reads=512,
                             read_len=2000, accuracy=0.95, seed=11)
    sprep = st.prepare_genome(small.genome)
    for nw, (W, K, O) in ((3, (192, 192, 97)), (4, (256, 256, 129))):
        c = st.AlignConfig(W=W, K=K, O=O, batch_tile=512)
        sst = kernel_time.stage_mapped(sprep, small.reads, c, dev)
        windows[nw] = (c, sst, compare(c, sst[1], sst[2], "512x2kbp"))
        counts[nw], strs = drive_path(f"wide-path-w{W}", c, small, sprep,
                                      dev, 4, 128)
        paths[nw] = (c, small, sprep, strs)
    # the benchmark cell's tile (w256_truth's shape): 1,024 bench reads
    c256 = st.AlignConfig(W=256, K=256, O=129, batch_tile=1024)
    sub256 = SimulatedDataset(genome=ds.genome, reads=ds.reads[:1024])
    st256 = kernel_time.stage_mapped(prepared, sub256.reads, c256, dev)
    cell = compare(c256, st256[1], st256[2], "w256 cell tile")
    cell_counts, _ = drive_path("w256-cell-path", c256, sub256, prepared,
                                dev, 4, 128)
    # one launch a call (strings, packed) at key 4, of the wide kernel only
    if cell_counts != {k: ({4: 2} if k is _cuda.GENASM_WINDOWS_WIDE else {})
                       for k in cell_counts}:
        raise AssertionError(f"the W=256 cell tile's launches: {cell_counts}")
    kernel_only("w256-kernel-only", st256, len(sub256.reads))

    kernels = []
    rows = [(nw, engine.window_kernel(c), c, sst, cmp, counts[nw])
            for nw, (c, sst, cmp) in sorted(windows.items())]
    rows.append((4, _cuda.GENASM_WINDOWS_WIDE, c256, st256, cell,
                 cell_counts))
    for nw, kern, c, sst, cmp, cnt in rows:
        launches = cnt[kern].get(nw, 0)
        entry = window_entry(c, nw)
        name = entry["name"]
        if launches < 1:
            raise AssertionError(f"{name} never launched on its path")
        bound_ms, bound_by, detail = model.window_bound(
            c, sst[1], sst[2], cmp["plain"], ops_rate)
        phase("bound", kernel=name, W=c.W, bound_ms=f"{bound_ms:.6f}",
              bound_by=bound_by, **{k: v for k, v in detail.items()})
        if c.W in (64, 128):  # the bench tile: profiling.model sol beside
            sol = model.sol_estimate(c.W, c.K, c.O, 10000, 0.05, sst[3],
                                     ops_rate)
            phase("sol", kernel=name, W=c.W, B=sst[3],
                  **{k: (f"{v:.6g}" if isinstance(v, float) else v)
                     for k, v in sol.items()},
                  counted_over_expected=f"{bound_ms / sol['bound_ms']:.4f}")
        kernels.append({
            **entry, "launches": launches, "max_abs_err": cmp["max_abs_err"],
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
        wide_kernels, w512 = wide_windows(ds, prepared, small, sprep, dev,
                                          ops_rate, tmp, paths)
        kernels += wide_kernels

    # ---- 11. several devices ----
    mesh_path(ds, prepared, main_strs, cfg)
    with tempfile.TemporaryDirectory(prefix="scrooge_parallel_") as tmp:
        distributed_path(ds, main_strs, tmp)
        scaling_path(kind, tmp)

    # ---- 12. the tile pipeline ----
    with tempfile.TemporaryDirectory(prefix="scrooge_pipeline_") as tmp:
        pipeline_path(ds, prepared, {64: main_strs, 128: wide_strs}, tmp)

    # ---- 13. early termination off ----
    tiles = {"bench tile W=64": (cfg, staged, main_tile["plain"]),
             "bench tile W=128": (wcfg, wstaged, wide_tile["plain"]),
             "1024 bench reads W=256": (c256, st256, cell["plain"]),
             "1024 bench reads W=512": w512}
    kernels += et_off(tiles, paths, dev, ops_rate)

    # ---- 14. the bench ----
    bench_path()

    # ---- 15. packed assembly into pair order ----
    assembly_path(ds, prepared, main_strs, dev)

    # ---- 16. the token kernel ----
    kernels.append(tokens_path(
        dev, sum(counts[1][_cuda.GENASM_TOKENS].values())))

    # ---- 17. the one-word kernel on w64_chained's tile ----
    kernels.append(windows1_path(
        dev, ops_rate, counts[1][_cuda.GENASM_WINDOWS1].get(1, 0), against))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--against"]:
        sys.exit(main(tuple(sys.argv[2:])))
    sys.exit(main())
