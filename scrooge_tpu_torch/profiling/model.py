"""Analytical models: the GenASM ASIC vault, and the H100 bound of the port.

Port of scrooge_tpu/profiling/model.py:

1. **ASIC vault model** (:57-158, ``improvements`` and ``sweep``): the
   reference's analytical model of a GenASM-style accelerator
   (scripts/asic_numbers.py:75-295): per-window latency, TB-SRAM sizing
   under the four SENE/DENT layouts, area and power scaled linearly from
   the published 28nm GenASM numbers. Plain arithmetic, as in the JAX
   module, and held to it row for row.

2. **The H100 bound** (``sol``): the least time the card could take for a
   window engine call or a fill-lab run, the larger of its INT32
   instructions over the card's INT32 rate and its bytes over the memory
   rate. This is the bound every kernel row of ``chip_smoke.py`` and
   PERF.md stands beside (``window_bound``, ``fill_bound``, ``r_floor``).
   Its counts come from the plain engine's ``work`` counters on real
   inputs, or, for a shape alone, from ``expected_rows`` (:187). The INT32
   rate is read from the card: SMs x 64 INT32 lanes x the SM's max clock.

The JAX module's ``tpu`` mode (``tpu_aligns_per_second``, a model of the
Pallas kernel calibrated on a v5e) and its v5e ``sol`` model have no
counterpart: no TPU rate or constant is carried over. ``sol`` takes their
place.

CLI:
  python -m scrooge_tpu_torch.profiling.model improvements
  python -m scrooge_tpu_torch.profiling.model sweep [--out=asic_sweep.csv]
  python -m scrooge_tpu_torch.profiling.model sol [--W=64 --K=64 --O=33]
      [--read_len=10000] [--error_rate=0.05] [--batch=16384]
      [--int32_tops=T] [--counted --device=cpu|cuda]

``sol`` reads the INT32 rate of card 0 unless ``--int32_tops`` gives it.
``--counted`` also simulates the batch (seed 7), runs the plain engine on
``--device`` and prints the bound of its work counters.
"""

from __future__ import annotations

import argparse
import csv
import math
import subprocess
import sys
from itertools import product

KIBI = 1024

# Published GenASM per-vault reference points (28nm, 1 GHz), the scaling
# anchors of the model (asic_numbers.py:162-220).
GENASM_PES = 64
GENASM_DC_SRAM = 8 * KIBI
GENASM_TB_SRAM = 96 * KIBI
GENASM_DC_LOGIC_AREA = 0.049  # mm^2
GENASM_TB_LOGIC_AREA = 0.016
GENASM_DC_SRAM_AREA = 0.013
GENASM_TB_SRAM_AREA = 0.256
GENASM_DC_LOGIC_POWER = 0.033  # W
GENASM_TB_LOGIC_POWER = 0.004
GENASM_DC_SRAM_POWER = 0.009
GENASM_TB_SRAM_POWER = 0.055


def single_window_latency(W: int, O: int, pes: int) -> int:
    """Cycles per window: DC = (2W+1) per block of <=PES chars, TB = W-O."""
    dc_cycles_per_block = 2 * W + 1
    blocks = math.ceil(W / pes)
    return dc_cycles_per_block * blocks + (W - O)


def sequence_latency(seq_len: int, W: int, O: int, pes: int) -> int:
    windows = math.ceil(seq_len / (W - O))
    return single_window_latency(W, O, pes) * windows


def vault_throughput(seq_len: int, W: int, O: int, pes: int,
                     frequency: float) -> float:
    return frequency / sequence_latency(seq_len, W, O, pes)


def dc_bytes(W: int) -> float:
    """DC-SRAM scales linearly with W from the 8 KiB @ W=64 anchor."""
    return GENASM_DC_SRAM / 64 * W


def tb_memory(W: int, O: int, sene: bool, dent: bool):
    """(columns, bits_per_column, bandwidth_per_column) of the TB SRAM for
    each storage layout (asic_numbers.py:111-136):
      neither: 3 edge bitvectors of W bits, W x W
      SENE:    1 entry bitvector of W bits, (W+1) x W
      DENT:    3 edge bitvectors of W-O bits, W x (W-O)
      both:    1 entry of min(W-O+1, W) bits, (W+1) x min(W-O+1, W)
    """
    if not sene and not dent:
        bits, per_entry, rows, cols = W, 3, W, W
    elif sene and not dent:
        bits, per_entry, rows, cols = W, 1, W + 1, W
    elif dent and not sene:
        bits, per_entry, rows, cols = W - O, 3, W, W - O
    else:
        bits, per_entry, rows, cols = min(W - O + 1, W), 1, W + 1, \
            min(W - O + 1, W)
    return cols, bits * per_entry * rows, bits * per_entry


def area(W: int, O: int, pes: int, sene: bool, dent: bool):
    """(dc_logic, tb_logic, dc_sram, tb_sram) mm^2 per vault."""
    dc_logic = pes * GENASM_DC_LOGIC_AREA / GENASM_PES
    dc_sram = dc_bytes(W) * GENASM_DC_SRAM_AREA / GENASM_DC_SRAM
    tb_logic = GENASM_TB_LOGIC_AREA + (
        GENASM_DC_LOGIC_AREA / GENASM_PES if sene else 0)
    cols, bits_per_col, _ = tb_memory(W, O, sene, dent)
    tb_bytes = math.ceil(cols * bits_per_col / 8)
    tb_sram = tb_bytes * GENASM_TB_SRAM_AREA / GENASM_TB_SRAM
    return dc_logic, tb_logic, dc_sram, tb_sram


def power(W: int, O: int, pes: int, sene: bool, dent: bool):
    """(dc_logic, tb_logic, dc_sram, tb_sram) W per vault."""
    dc_logic = pes * GENASM_DC_LOGIC_POWER / GENASM_PES
    dc_sram = dc_bytes(W) * GENASM_DC_SRAM_POWER / GENASM_DC_SRAM
    tb_logic = GENASM_TB_LOGIC_POWER + (
        GENASM_DC_LOGIC_POWER / GENASM_PES if sene else 0)
    cols, bits_per_col, _ = tb_memory(W, O, sene, dent)
    tb_bytes = math.ceil(cols * bits_per_col / 8)
    tb_sram = tb_bytes * GENASM_TB_SRAM_POWER / GENASM_TB_SRAM
    return dc_logic, tb_logic, dc_sram, tb_sram


def print_improvements(out=sys.stdout):
    """The Scrooge-vs-GenASM headline table (asic_numbers.py:222-252):
    SENE+DENT at W=64 O=33 vs neither."""
    def dump(tag, vals, unit):
        print(f"{tag}: {sum(vals):.3f}{unit}", file=out)
        for name, v in zip(("DC Logic", "TB Logic", "DC SRAM", "TB SRAM"),
                           vals):
            print(f" - {name}: {v:.3f}{unit}", file=out)

    ga = area(64, 33, 64, False, False)
    sa = area(64, 33, 64, True, True)
    dump("GenASM Area", ga, "mm^2")
    dump("Scrooge Area", sa, "mm^2")
    print(f"Area Improvement: {sum(ga) / sum(sa):.3f}x\n", file=out)

    gp = power(64, 33, 64, False, False)
    sp = power(64, 33, 64, True, True)
    dump("GenASM Power", gp, "W")
    dump("Scrooge Power", sp, "W")
    print(f"Power Improvement: {sum(gp) / sum(sp):.3f}x\n", file=out)


def sweep_rows(seq_len: int = 10_000, frequency: float = 1e9):
    """Config sweep rows (asic_numbers.py:254-295 schema)."""
    rows = []
    for W, O, sene, dent in product([64], range(0, 128), [False, True],
                                    [False, True]):
        if O >= W:
            continue
        a = area(W, O, 64, sene, dent)
        p = power(W, O, 64, sene, dent)
        tput = vault_throughput(seq_len, W, O, 64, frequency)
        rows.append([W, O, sene, dent, sum(a), sum(p), tput])
    return rows


def expected_rows(W: int, O: int, error_rate: float, batch: int, *,
                  K: int = None, early_termination: bool = True) -> float:
    """Expected DP rows per window with batched early termination: the
    max window edit distance over `batch` lockstep lanes, approximated
    from the Binomial(W-O, error_rate) upper tail, at most K+1 (K
    defaults to W, the sweeps' K). Without early termination every
    window fills rows 0..K: K+1."""
    K = W if K is None else K
    if not early_termination:
        return K + 1
    tb = W - O
    mean = tb * error_rate
    std = math.sqrt(max(tb * error_rate * (1 - error_rate), 1e-9))
    # expected max of `batch` iid ~ mean + std * sqrt(2 ln batch)
    return min(mean + std * math.sqrt(2 * math.log(max(batch, 2))) + 1,
               K + 1)



# --- The H100 bound -------------------------------------------------
#
# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the full power limit.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64    # Hopper SM: 4 partitions x 16 INT32 units
# the H100 SXM's INT32 rate from its data sheet (132 SMs, 1980 MHz max
# SM clock), for callers with no card to read (plots); a card's own rate
# is int32_ops_per_s()
H100_SXM_INT32_OPS_PER_S = 132 * INT32_LANES_PER_SM * 1980e6
TB_STEP_OPS = 12           # int32 ops per traceback step: 3 bit tests
# INT32 instructions a DP cell takes per 64-bit word of its bitvectors
# (window_bound derives it), and a cell of row 0, which has no row above
# (fill_bound)
CELL_OPS_PER_WORD = 8
ROW0_OPS_PER_WORD = 4


def int32_ops_per_s(index: int = 0) -> float:
    """Card ``index``'s INT32 rate: SMs x 64 INT32 lanes x the SM's max
    clock (nvidia-smi's clocks.max.sm)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader",
         f"--id={index}"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0].split()[0])
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def _bound(ops: int, nbytes: int, ops_rate: float):
    t_ops, t_bytes = ops / ops_rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def filled_cells(cfg, res) -> int:
    """DP cells a window engine fills on the inputs of ``res``, a plain
    result (its work counters): the counted cells with early
    termination; without, every window's K+1 rows of n+1 cells, which
    the count of one row's cells over the windows (work[2]) gives from a
    result of either setting (the windows do not depend on it)."""
    if cfg.early_termination:
        return int(res.work[0].sum().item())
    return (cfg.K + 1) * int(res.work[2].sum().item())


def window_ops(W: int, cells: int, steps: int) -> int:
    """INT32 instructions of ``cells`` DP cells and ``steps`` traceback
    steps at window width W (window_bound)."""
    nw = -(-W // 64)
    return cells * CELL_OPS_PER_WORD * nw + steps * TB_STEP_OPS


def window_bytes(B: int, read_chars: int, runs: int, maxw: int) -> int:
    """Bytes a window engine call must move (window_bound)."""
    # text and pattern: about as many text chars are consumed as read
    return (2 * read_chars // 4 + 16 * B + 2 * runs + 4 * maxw * B
            + 24 * B)


def window_bound(cfg, maxw, args, res, ops_rate):
    """Least time the window engine could take on this run's inputs:
    (ms, 'bytes' or 'operations', detail). ``args`` are the inputs of
    engine.align_windows, ``res`` the plain version's result on them.

    Operations: every DP cell the run filled (filled_cells: the work
    counters, with the config's early termination, of a plain result of
    either setting; the kernel fills the same cells, d = 0 cells counted
    alike) at
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
    cells = filled_cells(cfg, res)
    steps = int(res.work[1].sum().item())
    ops = window_ops(cfg.W, cells, steps)
    B = int(args[4].shape[0])
    nbytes = window_bytes(B, int(args[4].long().sum().item()),
                          int(res.counts.long().sum().item()), maxw)
    ms, by = _bound(ops, nbytes, ops_rate)
    return ms, by, dict(cells=cells, tb_steps=steps, int32_ops=ops,
                        bytes=nbytes)


def r_floor(cfg, res):
    """Bytes of R a tile must write, and their time at the memory rate:
    every searched row's stored words (the words of bits [O-1, W) of
    columns < COLS), the rows counted from the DP cells (filled_cells; a
    row of a window with n chars of text is n+1 cells, n <= W), so a
    floor; the kernel writes up to a pass's rows more a window."""
    rows = filled_cells(cfg, res) // (cfg.W + 1)
    stored = -(-cfg.W // 64) - max(cfg.O - 1, 0) // 64
    nbytes = rows * stored * cfg.columns * 8
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


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
    from ..tools import kernel_lab as lab

    wed = wed.long().cpu()
    cols = n.long().cpu().clamp(0, lab.W + 1)
    deep = 0 if variant == "noff" else CELL_OPS_PER_WORD
    ops = lab.NWIN * int((cols * (ROW0_OPS_PER_WORD + wed * deep)).sum())
    B = int(wed.numel())
    nbytes = lab.W * B * 8 + B * (4 + 4 + 4 + 8)
    if variant == "full":
        nbytes += int((wed + 1).sum()) * lab.COLS * 8
    return _bound(ops, nbytes, ops_rate)


def sol_estimate(W: int, K: int, O: int, read_len: int, error_rate: float,
                 batch: int, ops_rate: float,
                 early_termination: bool = True) -> dict:
    """The bound of a shape alone, from expected counts: windows of
    ceil(read_len / tb_limit * (1 + e)), expected_rows(W, O, e, 1) rows a
    window with early termination (each pair's fill stops at its own
    distance: no lanes in lockstep), K+1 without, W+1 cells a row,
    tb_limit traceback steps and
    2 tb_limit e + 1 runs a window. An estimate: window_bound on the
    plain engine's counters is the bound of real inputs."""
    tb = W - O
    windows = math.ceil(read_len / tb * (1 + error_rate))
    rows = expected_rows(W, O, error_rate, 1, K=K,
                         early_termination=early_termination)
    cells = int(batch * windows * rows * (W + 1))
    steps = batch * windows * tb
    runs = int(batch * windows * (2 * tb * error_rate + 1))
    maxw = -(-(math.ceil(read_len * 1.34 / max(1, tb)) + 4) // 32) * 32
    ops = window_ops(W, cells, steps)
    nbytes = window_bytes(batch, batch * read_len, runs, maxw)
    ms, by = _bound(ops, nbytes, ops_rate)
    return {"windows": windows, "rows_per_window": rows, "cells": cells,
            "tb_steps": steps, "int32_ops": ops, "bytes": nbytes,
            "bound_ms": ms, "bound_by": by,
            "aligns_per_second_bound": batch / ms * 1e3}


def sol_counted(W: int, K: int, O: int, read_len: int, error_rate: float,
                batch: int, ops_rate: float, device: str = "cuda") -> dict:
    """window_bound of ``batch`` simulated reads (simulate_dataset, seed
    7, accuracy 1 - error_rate, one location each) on the plain engine's
    work counters, run on ``device``."""
    import numpy as np
    import torch

    from .. import api
    from ..config import AlignConfig
    from ..ops import engine, pack
    from ..utils.simulate import simulate_dataset

    cfg = AlignConfig(W=W, K=K, O=O, batch_tile=-(-batch // 128) * 128)
    ds = simulate_dataset(genome_len=max(4 * read_len, 100_000),
                          num_reads=batch, read_len=read_len,
                          accuracy=1 - error_rate, seed=7)
    dev = api.resolve_device(device)
    glen = len(ds.genome.content)
    longest = max(len(r.content) for r in ds.reads) or 1
    maxw = api._maxw(cfg, longest)
    starts = np.array([r.locations[0].start_in_reference for r in ds.reads],
                      np.int64)
    tlen = np.minimum(glen - starts, maxw * cfg.tb_limit + cfg.W).astype(
        np.int32)
    plen = np.array([len(r.content) for r in ds.reads], np.int32)
    words = pack.encode_pack_host([r.content for r in ds.reads], longest)
    args = (api.PreparedGenome(ds.genome).device_words(dev),
            torch.from_numpy(starts).to(dev), torch.from_numpy(tlen).to(dev),
            pack.to_device(words, dev), torch.from_numpy(plen).to(dev))
    res = engine.align_windows_plain(cfg, maxw, *args)
    ms, by, detail = window_bound(cfg, maxw, args, res, ops_rate)
    return {**detail, "bound_ms": ms, "bound_by": by,
            "aligns_per_second_bound": batch / ms * 1e3}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["improvements", "sweep", "sol"])
    p.add_argument("--out", default="asic_sweep.csv")
    p.add_argument("--W", type=int, default=64)
    p.add_argument("--K", type=int, default=64)
    p.add_argument("--O", type=int, default=33)
    p.add_argument("--read_len", type=int, default=10_000)
    p.add_argument("--error_rate", type=float, default=0.05)
    p.add_argument("--batch", type=int, default=16_384)
    p.add_argument("--int32_tops", type=float, default=None,
                   help="INT32 rate in Tops/s (default: read from card 0)")
    p.add_argument("--counted", action="store_true",
                   help="also the bound of the plain engine's counters on "
                        "a simulated batch")
    p.add_argument("--device", default="cuda", help="device of --counted")
    args = p.parse_args(argv)

    if args.mode == "improvements":
        print_improvements()
    elif args.mode == "sweep":
        rows = sweep_rows()
        with open(args.out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["W", "O", "SENE", "DENT", "area_mm2", "power_W",
                        "aligns_per_second_per_vault"])
            w.writerows(rows)
        print(f"wrote {len(rows)} rows to {args.out}")
    else:
        rate = (args.int32_tops * 1e12 if args.int32_tops
                else int32_ops_per_s())
        shape = (args.W, args.K, args.O, args.read_len, args.error_rate,
                 args.batch, rate)
        print(f"int32_tops: {rate / 1e12:.3f}")
        runs = [("expected", sol_estimate(*shape))]
        if args.counted:
            runs.append(("counted", sol_counted(*shape, device=args.device)))
        for name, pred in runs:
            for k, v in pred.items():
                print(f"{name} {k}: {v:.6g}" if isinstance(v, float)
                      else f"{name} {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
