"""Window lab: where a window kernel's time goes.

Source variants of a window kernel, built with nvcc as the kernel itself
is and launched through the same entry point on the same staged tile
(the bench workload: 1 Mbp genome, 10 kbp reads at 95 % accuracy, seed 7)
at the source's configuration:

``csrc/genasm_windows1.cu`` (one word, W=64 K=64 O=33, the main path):

  full     the source as it is: the kernel the main path launches, a
           warp a pair, 32 rows a pass at a row a thread, each thread a
           column behind the one above (the row above's cell comes down
           by a shuffle the step it is used)
  clocks   full with SM clock reads (clock64) around each window's three
           sections, set-up, fill and traceback, summed per pair
  u8       UNROLL = 8: the first hit looked for every 8 steps, so a pass
           with a hit ends up to 8 steps sooner (full: 16)

``csrc/genasm_windows.cu`` (two and three words, W=128 K=128 O=65, the
wide path):

  full     the source as it is
  clocks   as above
  ffsmem   the forefront row in shared memory (dynamic, one 32-lane
           block's rows) instead of device memory; blocks of 32 threads
  tb8      CH = 8 traceback offsets a batch of R loads at two words (full
           has 4)

``csrc/genasm_windows_wide.cu`` (four to 32 words, W=512 K=512 O=257
on 1,024 reads, the W=512 path's tile):

  full     the source as it is: a warp a pair, 4 rows a pass at G = 8
           (8 at NW = 4, where G = 4)
  clocks   full with SM clock reads: set-up / fill / traceback cycles and
           the fill's column steps, per thread (so that it applies to
           another version of the file too, ``--kernel_file``)
  u8       UNROLL = 8: the forefront ring 8 steps deep (full has 16)
  u32      UNROLL = 32: 32 steps deep
  rows1    one row a pass (MAX_ROWS = 1; full has 32/G, 4 at G = 8)
  rows2    two rows a pass
  t64      64 threads a block (full has 32)
  nocs     R stored without the streaming hint
  g8       NW = 4 (W = 193..256) on groups of G = 8, four rows a pass,
           half of each group idle (full has G = 4, eight rows a pass):
           time it on a four-word tile, ``--wko 256 256 129``

``csrc/genasm_fill_lab.cu`` (the fill lab, kernel_lab.py's kernel, at
2048 and 16384 lanes, its full / nostore / noff each):

  full     the source as it is: G = 8 threads a lane, 64 a block
  g4       G = 4 threads a lane
  g16      G = 16 threads a lane

A variant is the source with named text edits, each of which must match
exactly once, so a change to the kernel that moves an anchor fails here
rather than timing something else. No variant changes what the kernel
computes: each must give full's output exactly (a fill-lab variant:
run_plain's wed, sums and R). Samples are timed with CUDA events, the
variants in turns: 3 calls a sample on the tile, one 64-window launch
in the fill lab.

    python -m scrooge_tpu_torch.tools.window_lab [variant ...] \\
        [--source genasm_windows1.cu|genasm_windows.cu|
                  genasm_windows_wide.cu|genasm_fill_lab.cu] \\
        [--reads N] [--kernel_file PATH] [--against PATH ...]
        [--wko W K O]

``--reads`` defaults to 16384 (1024 for the wide source). ``--kernel_file``
builds the variants from another version of the source (the parent's,
unpacked with ``git archive``), with the same entry point and scratch; at
one word the argument that takes the row counters is sized for the R
scratch the one-thread-a-pair version of the kernel took there
(``thread_pair_r_words``). ``--against`` adds each file given (another
version of the source, such as the parent's) as the variant
``against1``, ``against2``, ..., held to the same output and timed in
the same turns. ``--wko`` runs the tile at another W, K, O than the
source's own (one the source's entry point takes).

needs a CUDA card: there is no plain version of a timing variant.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import statistics
import subprocess

import torch

from ..api import resolve_device
from ..buildcache import BUILD_DIR
from ..config import AlignConfig
from ..ops import _cuda, engine

SECTIONS = ("set-up", "fill", "traceback")


def _before(anchor: str, text: str):
    """An edit that puts ``text`` in front of the line ``anchor``."""
    return anchor, text + anchor


def _clock(k: int) -> str:
    """Adds the SM cycles since the last clock read to section k."""
    return (f"      {{ const long long c = clock64(); cyc[{k}] += "
            "(unsigned long long)(c - c_at); c_at = c; }\n")


# the multiword kernel's anchors, and its names LB, K and row_stride
_CLOCKS = (
    _before("  for (int w = 0; w < max_windows; ++w) {\n",
            "  unsigned long long cyc[3] = {0, 0, 0};  // by section\n"
            "  long long c_at = 0;\n"),
    _before("      // ---- (a) window set-up from packed words ----\n",
            "      c_at = clock64();\n"),
    _before("      // ---- (b) DP fill (pyref.genasm_dc), two rows a "
            "pass ----\n", _clock(0)),
    _before("      if (wed < 0) {\n", _clock(1)),
    _before("        // ---- carry update (engine_xla.py:339-350) "
            "----\n", _clock(2)),
    # the sums go past the end of R, which the lab allocates 3 B longer
    _before("  ed_out[b] = ed;\n",
            "  uint64_t* cy = R + (size_t)((B + LB - 1) / LB) * (K + 2)"
            " * row_stride;\n"
            "  cy[b] = cyc[0];\n  cy[nb + b] = cyc[1];\n"
            "  cy[2 * nb + b] = cyc[2];\n"),
)


# the one-word kernel's: a pair's sums, made by every thread alike and
# written by thread 0 after the row counters, three words a pair (launch
# allocates them)
_W1_CLOCKS = (
    _before("  for (int win = 0; win < P.max_windows; ++win) {\n",
            "  unsigned long long cyc[3] = {0, 0, 0};  // by section\n"
            "  long long c_at = 0;\n"),
    _before("      // ---- window set-up from packed words, the same in "
            "every thread ----\n", "      c_at = clock64();\n"),
    _before("      // ---- DP fill (pyref.genasm_dc), ROWS rows a pass ----\n",
            _clock(0)),
    _before("      if (wed < 0) {\n        failed |= FAIL_TB;", _clock(1)),
    _before("        // ---- carry update (engine_xla.py:339-350) ----\n",
            _clock(2)),
    _before("    count_add(P.rows, slots);\n",
            "    P.rows[2 + b] = (int64_t)cyc[0];\n"
            "    P.rows[2 + nb + b] = (int64_t)cyc[1];\n"
            "    P.rows[2 + 2 * nb + b] = (int64_t)cyc[2];\n"),
)


def _after(anchor: str, text: str):
    """An edit that puts ``text`` after ``anchor``."""
    return anchor, anchor + text


# The wide kernel's clock reads, per thread, on anchors that this file and
# its first version (one row a pass) share: a step counter on the column
# loop of either, and the sums, 4 words a thread by global thread id, in
# the forefront scratch past B * (W + 4 * MAX_NW) * NW words, beyond
# either version's forefronts (launch allocates them).
_WIDE_CLOCKS = (
    _before("  for (int win = 0; win < P.max_windows; ++win) {\n",
            "  unsigned long long cyc[4] = {0, 0, 0, 0};  // sections, steps\n"
            "  long long c_at = 0;\n"),
    _before("    // ---- window set-up, each thread its word ----\n",
            "      c_at = clock64();\n"),
    _before("    // ---- DP fill (pyref.genasm_dc)", _clock(0)),
    _before("    // ---- level traceback (engine_pallas.py level_body) ----\n",
            _clock(1)),
    _after(" = nrun;\n", _clock(2)),
    # alternatives: the first version's column loop, this one's blocks
    (("      for (int i = W - 1; i >= 0; --i) {\n",
      "      for (int blk = 0; blk < nblocks; ++blk) {\n"),
     ("      cyc[3] += (unsigned long long)W;\n"
      "      for (int i = W - 1; i >= 0; --i) {\n",
      "      cyc[3] += (unsigned long long)nblocks * UNROLL;\n"
      "      for (int blk = 0; blk < nblocks; ++blk) {\n")),
    _before("}\n\n}  // namespace\n\n#ifdef __CUDACC__\n",
            "  {\n    uint64_t* cy = P.ff + nb * (W + 4 * MAX_NW) * NW +\n"
            "        ((size_t)blockIdx.x * THREADS + threadIdx.x) * 4;\n"
            "    for (int k = 0; k < 4; ++k) cy[k] = cyc[k];\n  }\n"),
)
WIDE_CLOCK_WORDS = 4 * 32  # words of clock sums a pair, at most

# source -> (kernel, (W, K, O) of its tile, {variant: (anchor, new) edits})
# each anchor must occur once in the source; an edit whose anchor is a
# tuple takes the one alternative the source holds (its text at the same
# index)
SOURCES = {
    "genasm_windows1.cu": (_cuda.GENASM_WINDOWS1, (64, 64, 33), {
        "full": (),
        "clocks": _W1_CLOCKS,
        "u8": (("constexpr int UNROLL = 16;",
                "constexpr int UNROLL = 8;"),),
    }),
    "genasm_windows.cu": (_cuda.GENASM_WINDOWS, (128, 128, 65), {
        "full": (),
        "clocks": _CLOCKS,
        "ffsmem": (
            ("constexpr int THREADS = 64;", "constexpr int THREADS = 32;"),
            ("  uint64_t* __restrict__ fl = ff + (size_t)(b / LB) * fpitch"
             " + b % LB;\n",
             "  extern __shared__ uint64_t ff_smem[];  // a block's rows\n"
             "  uint64_t* __restrict__ fl = ff_smem + threadIdx.x;\n"),
            _before("  genasm_windows_kernel<NW, ET><<<grid, THREADS, 0, "
                    "stream>>>(\n",
                    "  const int smem = ff_cols(W) * NW * LB * 8;\n"
                    "  cudaFuncSetAttribute(genasm_windows_kernel<NW, ET>,\n"
                    "      cudaFuncAttributeMaxDynamicSharedMemorySize, "
                    "smem);\n"),
            ("  genasm_windows_kernel<NW, ET><<<grid, THREADS, 0, stream>>>(",
             "  genasm_windows_kernel<NW, ET><<<grid, THREADS, smem, "
             "stream>>>("),
        ),
        "tb8": (("  return NW == 2 ? 4 : 8;", "  return 8;"),),
    }),
    "genasm_windows_wide.cu": (_cuda.GENASM_WINDOWS_WIDE, (512, 512, 257), {
        "full": (),
        "clocks": _WIDE_CLOCKS,
        "u8": (("constexpr int UNROLL = 16;", "constexpr int UNROLL = 8;"),),
        "u32": (("constexpr int UNROLL = 16;",
                 "constexpr int UNROLL = 32;"),),
        "rows1": (("constexpr int MAX_ROWS = 8;",
                   "constexpr int MAX_ROWS = 1;"),),
        "rows2": (("constexpr int MAX_ROWS = 8;",
                   "constexpr int MAX_ROWS = 2;"),),
        "t64": (("constexpr int THREADS = 32;",
                 "constexpr int THREADS = 64;"),),
        "nocs": (("  __stcs((unsigned long long*)p, (unsigned long long)v);",
                  "  *p = v;"),),
        "g8": (("nw <= 4 ? (et ? &launch<4, true> : &launch<4, false>)",
                "nw <= 4 ? (et ? &launch<8, true> : &launch<8, false>)"),),
    }),
    "genasm_fill_lab.cu": (_cuda.GENASM_FILL_LAB, None, {
        "full": (),
        "g4": (("constexpr int G = 8;", "constexpr int G = 4;"),),
        "g16": (("constexpr int G = 8;", "constexpr int G = 16;"),),
    }),
}
FILL_LAB = "genasm_fill_lab.cu"
WIDE = "genasm_windows_wide.cu"
FILL_BATCHES = (2048, 16384)  # lanes the fill lab's variants are timed at
DEFAULT_SOURCE = "genasm_windows1.cu"
# the one-word kernel's variants
VARIANTS = tuple(SOURCES[DEFAULT_SOURCE][2])


def variant_source(variant: str, source: str = DEFAULT_SOURCE,
                   path: str | None = None) -> str:
    """The kernel source (or the file at ``path``, another version of it)
    with ``variant``'s edits; raises ValueError when an anchor does not
    occur exactly once."""
    if source not in SOURCES:
        raise ValueError(f"source {source!r} is not one of {tuple(SOURCES)}")
    kernel, _, edits = SOURCES[source]
    if variant not in edits:
        raise ValueError(f"variant {variant!r} is not one of "
                         f"{tuple(edits)}")
    with open(path or os.path.join(_cuda.CSRC, kernel.source)) as f:
        src = f.read()
    for anchor, new in edits[variant]:
        if isinstance(anchor, tuple):
            held = [k for k, a in enumerate(anchor) if a in src]
            if len(held) != 1:
                raise ValueError(f"{variant}: {len(held)} of the anchors "
                                 f"{anchor!r} occur in the kernel")
            anchor, new = anchor[held[0]], new[held[0]]
        if src.count(anchor) != 1:
            raise ValueError(f"{variant}: anchor {anchor.strip()!r} occurs "
                             f"{src.count(anchor)} times in the kernel")
        src = src.replace(anchor, new)
    return src


def variant_kernel(variant: str, source: str = DEFAULT_SOURCE,
                   path: str | None = None) -> _cuda.CudaKernel:
    """A CudaKernel for the variant's source (of the file at ``path``, if
    given), written under the build directory; ``full`` of the source
    itself is the kernel the engine launches."""
    kernel = SOURCES[source][0]
    if variant == "full" and path is None:
        return kernel
    # a file of its own for each version of the source built at once
    tag = hashlib.sha256(os.path.abspath(path or "").encode()).hexdigest()
    stem = os.path.splitext(kernel.source)[0] + (
        f"_file{tag[:8]}" if path else "")
    out = os.path.join(BUILD_DIR, "window_lab", f"{stem}_{variant}.cu")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(variant_source(variant, source, path))
    path = out
    return _cuda.CudaKernel(path, kernel.symbol, kernel.argtypes[1:])


def thread_pair_r_words(cfg, B: int) -> int:
    """int64 words of the R scratch that the one-thread-a-pair version of
    genasm_windows1.cu took in the argument that now takes the row
    counters: rows d <= K+1 of COLS columns, in blocks of 32 lanes."""
    return (cfg.K + 2) * cfg.columns * (-(-B // 32) * 32)


def launch(kernel, cfg, maxw, args, extra: int = 0, words: int = 0):
    """One launch with the engine's scratch (engine.scratch_words) and
    ``extra`` * B more int64 words after R. Returns (BatchResult, those
    extra words as an (extra, B) tensor). The wide kernel's clock sums go
    to the forefront scratch instead, past B * (W + 128) * NW words: there
    they come back as (extra * B / 4, 4), a row a thread. The one-word
    kernel, which has no scratch, gets its two row counters and the extra
    words after them, in a buffer of at least ``words`` words."""
    tw, base, tlen, pw, plen = args
    dev, B = pw.device, int(plen.shape[0])
    if engine.num_words(cfg.W) == 1:
        rows = torch.zeros(max(2 + extra * B, words), dtype=torch.int64,
                           device=dev)
        res = _launch(kernel, cfg, maxw, args, (rows.data_ptr(),))
        return res, rows[2:2 + extra * B].view(extra, B)
    nr, nf = engine.scratch_words(cfg, B)
    wide = engine.window_kernel(cfg) is _cuda.GENASM_WINDOWS_WIDE
    R = torch.empty(nr + (0 if wide else extra * B), dtype=torch.int64,
                    device=dev)
    scratch = (R.data_ptr(),)
    at = B * (cfg.W + 128) * engine.num_words(cfg.W)  # the clock sums
    if nf:
        ff = (torch.zeros(at + extra * B, dtype=torch.int64, device=dev)
              if wide and extra else
              torch.empty(nf, dtype=torch.int64, device=dev))
        scratch += (ff.data_ptr(),)
    res = _launch(kernel, cfg, maxw, args, scratch)
    if wide:
        return res, ff[at:].view(-1, 4)
    return res, R[nr:].view(extra, B)


def _launch(kernel, cfg, maxw, args, scratch) -> engine.BatchResult:
    """The kernel's launch on the tile with the scratch pointers given;
    its outputs."""
    tw, base, tlen, pw, plen = args
    dev, B = pw.device, int(plen.shape[0])
    ed = torch.empty(B, dtype=torch.int32, device=dev)
    failed = torch.empty(B, dtype=torch.int32, device=dev)
    entries = torch.zeros((maxw, engine.entry_rows(cfg), B),
                          dtype=torch.int16, device=dev)
    counts = torch.empty((maxw, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        kernel.launch(engine.kernel_key(cfg), tw.data_ptr(), tw.numel(),
                      base.data_ptr(), tlen.data_ptr(), pw.data_ptr(),
                      int(pw.shape[1]), plen.data_ptr(), B, cfg.W, cfg.K,
                      cfg.O, int(maxw), *scratch, ed.data_ptr(),
                      failed.data_ptr(), entries.data_ptr(),
                      counts.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
    return engine.BatchResult(ed, failed, entries, counts)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))


def _ptxas(log: str) -> str:
    """Registers and spill bytes of each instantiation, in build order."""
    regs = re.findall(r"Used (\d+) registers", log)
    spill = re.findall(r"(\d+) bytes spill stores", log)
    return (", ".join(f"{r} regs {s} B spill" for r, s in zip(regs, spill))
            if regs and spill else "built before this run")


def _max_sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return float(out.split()[0])


def time_in_turns(calls, rounds: int = 3, reps: int = 1):
    """``rounds`` samples of ``reps`` calls of each of ``calls`` (key ->
    function), the keys in turns, timed with CUDA events. Returns key ->
    ms a call of each sample."""
    samples = {key: [] for key in calls}
    for _ in range(rounds):
        for key, fn in calls.items():
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            t1.synchronize()
            samples[key].append(t0.elapsed_time(t1) / reps)
    return samples


def _rows(kernels, cases, same, samples, extra=None):
    """One dict per (variant, case): its check, samples and median, and
    ``extra[variant]``'s entries."""
    return [dict(variant=v, case=c, same=same[v], samples=samples[v, c],
                 median_ms=statistics.median(samples[v, c]),
                 ptxas=_ptxas(k.build_log), **(extra or {}).get(v, {}))
            for v, k in kernels.items() for c in cases]


def measure(variants, staged, rounds: int = 3, reps: int = 3,
            source: str = DEFAULT_SOURCE, path: str | None = None,
            against=()):
    """Each variant of ``source`` (of the file at ``path``, if given)
    built, held against the engine's own output on the staged tile, then
    timed in turns: ``rounds`` samples of ``reps`` calls each; the files
    in ``against`` (other versions of the source) as the variants
    ``against1``, ``against2``, ... in the same turns. Returns one dict
    per variant."""
    cfg, maxw, args, _ = staged
    kernels = {v: variant_kernel(v, source, path) for v in variants}
    other = {v: path for v in kernels}
    for k, file in enumerate(against, 1):
        kernels[f"against{k}"] = variant_kernel("full", source, file)
        other[f"against{k}"] = file
    _cuda.build_all(tuple(kernels.values()))
    want = engine.align_windows(cfg, maxw, *args)
    B = int(args[4].shape[0])
    extra = dict.fromkeys(kernels, 0)
    if "clocks" in kernels:
        extra["clocks"] = WIDE_CLOCK_WORDS if source == WIDE else 3
    words = {v: thread_pair_r_words(cfg, B) if other[v] and source ==
             DEFAULT_SOURCE else 0 for v in kernels}
    same, cycles = {}, {}
    for v, k in kernels.items():
        got, cyc = launch(k, cfg, maxw, args, extra[v], words[v])
        same[v] = _same(got, want)
        cycles[v] = dict(cycles=cyc)
    samples = time_in_turns(
        {(v, ""): (lambda k=k, e=extra[v], n=words[v]:
                   launch(k, cfg, maxw, args, e, n))
         for v, k in kernels.items()}, rounds, reps)
    return _rows(kernels, ("",), same, samples, cycles)


def measure_fill(variants, rounds: int = 3):
    """Each source variant of the fill lab, held against ``run_plain`` on
    the lab's inputs and the random (m, n) case (2 windows, 2048 lanes:
    wed, the sums and in full R's rows 0..wed), then timed in turns:
    ``rounds`` samples of one NWIN-window launch for every variant, lab
    variant and batch of FILL_BATCHES. Returns one dict per (variant,
    case), the case naming the lab variant and the batch."""
    from . import kernel_lab as lab

    dev = torch.device("cuda")
    kernels = {v: variant_kernel(v, FILL_LAB) for v in variants}
    _cuda.build_all(tuple(kernels.values()))
    same = dict.fromkeys(kernels, True)
    for mn in ((lab.M_DEFAULT, lab.W), (None, None)):
        args = [t.to(dev) for t in
                lab.from_lab_layout(*lab.lab_inputs(2048, 0, *mn))]
        for lv in lab.VARIANTS:
            want = lab.run_plain(lv, 2, *args)
            for v, k in kernels.items():
                got = lab.launch(k, lv, 2, *args)
                same[v] &= (torch.equal(got.wed, want.wed)
                            and int(got.total) == int(want.total)
                            and (lv != "full"
                                 or lab.r_mismatches(got, want) == 0))
    inputs = {B: [t.to(dev) for t in lab.from_lab_layout(*lab.lab_inputs(B))]
              for B in FILL_BATCHES}
    cases = {f"{lv} B={B}": (lv, B) for lv in lab.VARIANTS
             for B in FILL_BATCHES}
    samples = time_in_turns(
        {(v, c): (lambda k=k, lv=lv, B=B:
                  lab.launch(k, lv, lab.NWIN, *inputs[B]))
         for v, k in kernels.items() for c, (lv, B) in cases.items()},
        rounds)
    return _rows(kernels, cases, same, samples)


def section_split(cycles: torch.Tensor, mhz: float):
    """(3, B) per-lane SM cycles -> share of each section in the summed
    cycles, and the mean and largest lane total in ms at ``mhz``."""
    c = cycles.double()
    per = c.sum(1)
    total = c.sum(0)
    return dict(shares=[float(x) for x in per / per.sum()],
                mean_lane_ms=float(total.mean()) / (mhz * 1e3),
                max_lane_ms=float(total.max()) / (mhz * 1e3))


def wide_split(rows: torch.Tensor, mhz: float):
    """The wide kernel's (threads, 4) clock rows (three sections and the
    fill's column steps, zero for threads that never ran) -> section_split
    of the threads that ran, and the fill's SM cycles a column step."""
    ran = rows[rows[:, :3].sum(1) > 0].double()
    out = section_split(ran[:, :3].T, mhz)
    out["cycles_a_step"] = float(ran[:, 1].sum() / ran[:, 3].sum())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--source", default=DEFAULT_SOURCE, choices=SOURCES)
    ap.add_argument("--reads", type=int, default=None)
    ap.add_argument("--kernel_file", default=None)
    ap.add_argument("--against", nargs="+", default=())
    ap.add_argument("--wko", type=int, nargs=3, default=None,
                    metavar=("W", "K", "O"))
    args = ap.parse_args(argv)
    variants = args.variants or list(SOURCES[args.source][2])
    for v in variants:
        # names and anchors, before work
        variant_source(v, args.source, args.kernel_file)
    reads = args.reads or (1024 if args.source == WIDE else 16384)
    dev = resolve_device("cuda")
    variants = ["full"] + [v for v in variants if v != "full"]
    where = torch.cuda.get_device_name(dev)
    if args.source == FILL_LAB:
        rows, oracle = measure_fill(variants), "plain"
        where += ", 64 windows"
    else:
        import scrooge_tpu_torch as st
        from ..profiling import kernel_time
        from ..utils.simulate import simulate_dataset

        W, K, O = args.wko or SOURCES[args.source][1]
        cfg = AlignConfig(W=W, K=K, O=O, batch_tile=reads)
        ds = simulate_dataset(genome_len=1_000_000, num_reads=reads,
                              read_len=10000, accuracy=0.95, seed=7)
        staged = kernel_time.stage_mapped(st.prepare_genome(ds.genome),
                                          ds.reads, cfg, dev)
        rows = measure(variants, staged, source=args.source,
                       path=args.kernel_file, against=args.against)
        oracle = "the engine"
        where += f", {staged[3]} reads at W={W} K={K} O={O}"
        if args.kernel_file:
            where += f", {args.kernel_file}"
    full = {r["case"]: r["median_ms"] for r in rows
            if r["variant"] == "full"}
    for r in rows:
        samples = " ".join(f"{x:.3f}" for x in r["samples"])
        med = r["median_ms"]
        label = f"{r['variant']} {r['case']}".strip()
        print(f"{label:7s}: {samples} ms, median {med:.3f} "
              f"({med / full[r['case']]:.3f} x full), same output as "
              f"{oracle}: {r['same']}, {r['ptxas']} ({where})", flush=True)
        if r["variant"] == "clocks":
            wide = args.source == WIDE
            s = (wide_split if wide else section_split)(r["cycles"],
                                                        _max_sm_mhz())
            print("clocks : share of lane cycles "
                  + ", ".join(f"{n} {x:.3f}" for n, x in
                              zip(SECTIONS, s["shares"]))
                  + f"; lane total at the max SM clock: mean "
                  f"{s['mean_lane_ms']:.3f} ms, largest "
                  f"{s['max_lane_ms']:.3f} ms"
                  + (f"; fill cycles a column step "
                     f"{s['cycles_a_step']:.1f}" if wide else ""),
                  flush=True)
    if not all(r["same"] for r in rows):
        raise SystemExit(f"a variant's output differs from {oracle}'s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
