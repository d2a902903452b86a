"""Window engine: GenASM DP fill + traceback over every window of every lane.

Port of the JAX package's window engines:

- ``engine_pallas.align_batch`` / ``align_batch_mapped`` / ``_align_scan``
  and the Pallas kernel ``slab_step_kernel`` -> ``_multi_window_kernel``
  (scrooge_tpu/ops/engine_pallas.py:367-1123). On the card this is one
  hand-written kernel, ``csrc/genasm_windows.cu``: one thread per pair, one
  launch for all windows. It replaces the slab loop and the per-pair
  segment copy.
- ``engine_xla._window_step`` / ``_align_scan`` / ``align_batch[_mapped]``
  (scrooge_tpu/ops/engine_xla.py:105-443). ``align_windows_plain`` below is
  their lane-batched lockstep counterpart in torch ops. The CPU path and
  the tests use it, and on the card it is what the kernel is held against.

Output layout is engine_xla's dense one: ``entries`` (MAXW, NE, B) with
NE = 2*tb_limit + 2 rows, each window's runs in a dense prefix of its rows,
a run stored as ``op << 12 | count``; ``counts`` (MAXW, B).

Semantics that differ from the JAX engines, and why no output changes:

- the d-search always runs to the full ``cfg.K`` (no tb_cap), so a lane
  that fails FAIL_TB has no alignment within K and the scalar retry raises
  for it exactly as the JAX path does;
- there are no slabs, so FAIL_DRIFT never occurs;
- early termination is always on: the rows after the first hit are never
  read by the traceback.

Bitvectors are one 64-bit word (W <= 64), LSB-aligned as in the scalar
oracle (scrooge_tpu/pyref.py): pattern position j is bit m-1-j and the
full-match probe is bit m-1. torch's unsigned dtypes cannot shift, invert
or scatter on the CPU, so the plain version keeps them in int64: at W=64,
bit 63 is the sign bit, every right shift is followed by ``& 1`` (an
arithmetic shift only smears copies of bit 63 above the bit read), and
left shifts wrap as two's complement.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scrooge_tpu.config import AlignConfig

from . import _cuda
from .pack import unpack_codes

OP_EQ, OP_X, OP_I, OP_D = 0, 1, 2, 3
OP_NONE = 4
ENTRY_OP_SHIFT = 12
ENTRY_CNT_MASK = (1 << ENTRY_OP_SHIFT) - 1

# per-lane failure bits, the values of engine_pallas.py:108-111
FAIL_TB = 1          # no window alignment within K edits
FAIL_STALL = 2       # a window consumed no text and no pattern
FAIL_INCOMPLETE = 8  # the read was not consumed within max_windows

MAX_W = 64


class BatchResult(NamedTuple):
    edit_distance: torch.Tensor  # (B,) int32
    failed: torch.Tensor         # (B,) int32 FAIL_* bitmask, 0 = aligned
    entries: torch.Tensor        # (MAXW, NE, B) int16 runs op << 12 | count
    counts: torch.Tensor         # (MAXW, B) int32 runs per window


def check_config(cfg: AlignConfig) -> None:
    if cfg.W > MAX_W:
        raise NotImplementedError(
            f"W={cfg.W}: the torch port holds a window in one 64-bit word "
            "(W <= 64); wider windows wait for the multiword kernel, "
            "ROADMAP.md queue 1 'W > 64 multiword kernel'")


def entry_rows(cfg: AlignConfig) -> int:
    """Run rows per window: a window's traceback takes at most 2*tb_limit
    steps, hence at most that many runs (engine_xla.py:114)."""
    return 2 * cfg.tb_limit + 2


def _full_mask(W: int) -> int:
    """ones(W) as an int64 value (bit 63 is the sign bit at W=64)."""
    return -1 if W == 64 else (1 << W) - 1


def align_windows(cfg: AlignConfig, max_windows: int, text_words,
                  text_base, text_len, pattern_words,
                  pattern_len) -> BatchResult:
    """Align B pairs over exactly ``max_windows`` windows.

    text_words: int32 packed words, any shape, read flat; lane b's text
    char k is flat char ``text_base[b] + k`` (int64) and exists for
    k < text_len[b]. For read mapping, text_words is the device-resident
    packed genome and text_base the candidate starts (64-bit: genomes reach
    2^32 bases), text_len pre-clamped by the caller; align_batch covers
    unstructured pairs. pattern_words: (B, Pw) int32 packed rows;
    pattern_len (B,) int32.

    CPU tensors take the plain version. CUDA tensors launch the kernel;
    there is no fallback between the two.
    """
    check_config(cfg)
    dev = pattern_words.device
    if dev.type == "cpu":
        return align_windows_plain(cfg, max_windows, text_words, text_base,
                                   text_len, pattern_words, pattern_len)
    if dev.type == "cuda":
        return _align_windows_cuda(cfg, max_windows, text_words, text_base,
                                   text_len, pattern_words, pattern_len)
    raise ValueError(f"unsupported device {dev}")


def align_batch(cfg: AlignConfig, max_windows: int, text_words, text_len,
                pattern_words, pattern_len) -> BatchResult:
    """Unstructured pairs: text_words (B, Tw), pattern_words (B, Pw)."""
    B, Tw = text_words.shape
    base = torch.arange(B, dtype=torch.int64, device=text_words.device)
    return align_windows(cfg, max_windows, text_words, base * (Tw * 16),
                         text_len, pattern_words, pattern_len)


def _check_inputs(text_words, text_base, text_len, pattern_words,
                  pattern_len):
    B = pattern_len.shape[0]
    dev = pattern_words.device
    for name, t, dt in (("text_words", text_words, torch.int32),
                        ("text_base", text_base, torch.int64),
                        ("text_len", text_len, torch.int32),
                        ("pattern_words", pattern_words, torch.int32),
                        ("pattern_len", pattern_len, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pattern_words.dim() != 2 or pattern_words.shape[0] != B:
        raise ValueError("pattern_words must be (B, Pw)")
    if text_base.shape != (B,) or text_len.shape != (B,):
        raise ValueError("text_base and text_len must be (B,)")


def _align_windows_cuda(cfg, max_windows, text_words, text_base, text_len,
                        pattern_words, pattern_len) -> BatchResult:
    """Kernel wrapper: allocates outputs and scratch, launches once."""
    _check_inputs(text_words, text_base, text_len, pattern_words,
                  pattern_len)
    dev = pattern_words.device
    B = int(pattern_len.shape[0])
    NE = entry_rows(cfg)
    # R: rows d <= K, columns i < W-O+1 (DENT), lane-minor [row][col][lane]
    R = torch.empty((cfg.K + 1) * cfg.columns * B, dtype=torch.int64,
                    device=dev)
    ff = torch.empty((cfg.W + 1) * B, dtype=torch.int64, device=dev)
    ed = torch.empty(B, dtype=torch.int32, device=dev)
    failed = torch.empty(B, dtype=torch.int32, device=dev)
    entries = torch.zeros((max_windows, NE, B), dtype=torch.int16,
                          device=dev)
    counts = torch.empty((max_windows, B), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _cuda.GENASM_WINDOWS.launch(
            text_words.data_ptr(), text_base.data_ptr(),
            text_len.data_ptr(), pattern_words.data_ptr(),
            int(pattern_words.shape[1]), pattern_len.data_ptr(), B, cfg.W,
            cfg.K, cfg.O, int(max_windows), R.data_ptr(), ff.data_ptr(),
            ed.data_ptr(), failed.data_ptr(), entries.data_ptr(),
            counts.data_ptr(), stream)
    return BatchResult(ed, failed, entries, counts)


def align_windows_plain(cfg: AlignConfig, max_windows: int, text_words,
                        text_base, text_len, pattern_words,
                        pattern_len) -> BatchResult:
    """The plain torch version of the window engine, on any device.

    Lanes advance in lockstep, as in engine_xla: per window, a d-loop
    that stops once every active lane has found its distance, an i-loop
    that fills one row, then a traceback of at most 2*tb_limit steps.
    The loop over windows stops once every lane is done; later windows
    emit nothing in either engine.
    """
    _check_inputs(text_words, text_base, text_len, pattern_words,
                  pattern_len)
    W, K = cfg.W, cfg.K
    TB, COLS, NE = cfg.tb_limit, cfg.columns, entry_rows(cfg)
    dev = pattern_words.device
    B = int(pattern_len.shape[0])
    i64 = torch.int64

    def zeros(*shape, dtype=i64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    full = torch.tensor(_full_mask(W), dtype=i64, device=dev)
    tw = text_words.reshape(-1)
    pw = pattern_words.reshape(-1)
    tbase = text_base
    pbase = torch.arange(B, dtype=i64, device=dev) * (
        pattern_words.shape[1] * 16)
    tlen = text_len.to(i64)
    plen = pattern_len.to(i64)
    wi = torch.arange(W, dtype=i64, device=dev)
    col = torch.arange(W + 1, dtype=i64, device=dev)
    lane = torch.arange(B, dtype=i64, device=dev)

    ref_idx, read_idx, ed = zeros(B), zeros(B), zeros(B)
    failed = zeros(B, dtype=torch.int32)
    done = plen <= 0
    entries = zeros(max_windows, NE, B, dtype=torch.int16)
    counts = zeros(max_windows, B, dtype=torch.int32)
    R = zeros(K + 1, COLS, B)
    Rf = R.view(-1)

    for w in range(max_windows):
        act = ~done
        if not bool(act.any()):
            break
        m = torch.where(act, (plen - read_idx).clamp(0, W), 0)
        n = torch.where(act, (tlen - ref_idx).clamp(0, W), 0)

        # window codes; positions past n / m are never used, so they read
        # char 0 rather than past the end of the buffers
        tpos = (tbase + ref_idx)[:, None] + wi
        tch = unpack_codes(tw, torch.where(wi < n[:, None], tpos, 0))
        ppos = (pbase + read_idx)[:, None] + wi
        pch = unpack_codes(pw, torch.where(wi < m[:, None], ppos, 0))

        # pattern masks PM[c]: zero at bit m-1-j where pattern[j] == c
        # (pyref._pattern_masks); the bits are distinct, so a sum is an OR
        bit = torch.where(
            wi < m[:, None],
            torch.ones_like(tch) << (m[:, None] - 1 - wi).clamp(min=0), 0)
        pm = torch.stack([full & ~(bit * (pch == c)).sum(1)
                          for c in range(4)], 1)
        pmi = pm.gather(1, tch).T.contiguous()  # (W, B): PM[text[i]]
        is_start = col[:, None] >= n[None, :]   # (W+1, B): column i >= n

        # ---- DP fill (pyref.genasm_dc) ----
        found = ~act
        wed = zeros(B)
        probe = (m - 1).clamp(min=0)
        ff = None
        for d in range(K + 1):
            # start column i == n: ones at d == 0, ones << d after (an
            # x << 64 would be undefined in C, so d >= 64 saturates to 0)
            if d == 0:
                start = full
            elif d < 64:
                start = (full << d) & full
            else:
                start = torch.zeros_like(full)
            right = start.expand(B)
            cols = [right]
            if d == 0:
                for i in range(W - 1, -1, -1):
                    mat = ((right << 1) & full) | pmi[i]
                    right = torch.where(is_start[i], start, mat)
                    cols.append(right)
            else:
                # sub & ins & del for every column at once, from row d-1:
                # (R[d-1][i+1] << 1) & (R[d-1][i] << 1) & R[d-1][i+1]
                ins = (ff << 1) & full
                x = ins[1:] & ins[:-1] & ff[1:]
                for i in range(W - 1, -1, -1):
                    # x is masked to W bits, so (right << 1) needs no mask
                    c = ((right << 1) | pmi[i]) & x[i]
                    right = torch.where(is_start[i], start, c)
                    cols.append(right)
            ff = torch.stack(cols[::-1])  # (W+1, B), column-major
            R[d] = ff[:COLS]
            hit = ~found & (((right >> probe) & 1) == 0)
            wed = torch.where(hit, d, wed)
            found = found | hit
            if bool(found.all()):
                break

        # ---- traceback (pyref.genasm_tb), one step per iteration ----
        tb = act & found
        i, j, dd = zeros(B), zeros(B), wed.clone()
        cur_op = torch.full((B,), OP_NONE, dtype=i64, device=dev)
        cur_cnt, nfl = zeros(B), zeros(B)
        ent = zeros(NE + 1, B, dtype=torch.int16)  # row NE: discard sink

        def emit(flush):
            val = ((cur_op << ENTRY_OP_SHIFT) | cur_cnt).to(torch.int16)
            ent.scatter_(0, torch.where(flush, nfl, NE)[None], val[None])

        for _ in range(2 * TB):  # every step consumes text or pattern
            run = tb & (j < m) & (i < TB) & (j < TB)
            if not bool(run.any()):
                break
            i_limit = i >= n
            d_limit = dd == 0
            jlast = j == m - 1  # pyref.py:261-266 special case
            row = (dd - 1).clamp(min=0) * COLS
            va = Rf[(row + i.clamp(max=COLS - 1)) * B + lane]
            vb = Rf[(row + (i + 1).clamp(max=COLS - 1)) * B + lane]
            b_j = (m - 1 - j).clamp(min=0)
            b_j1 = (m - 2 - j).clamp(min=0)
            z_ins = ((va >> b_j1) & 1) == 0
            z_del = ((vb >> b_j) & 1) == 0
            z_sub = ((vb >> b_j1) & 1) == 0
            can_ins = ~d_limit & (jlast | z_ins)
            can_del = ~d_limit & ~jlast & ~i_limit & z_del
            can_sub = ~d_limit & ~i_limit & (jlast | z_sub)
            op = torch.where(can_ins, OP_I, torch.where(
                can_del, OP_D, torch.where(can_sub, OP_X, OP_EQ)))
            changed = run & (op != cur_op)
            flush = changed & (cur_cnt > 0)
            emit(flush)
            nfl = nfl + flush.long()
            cur_cnt = torch.where(run, torch.where(changed, 1, cur_cnt + 1),
                                  cur_cnt)
            cur_op = torch.where(changed, op, cur_op)
            i = i + (run & (op != OP_I)).long()
            j = j + (run & (op != OP_D)).long()
            dd = dd - (run & (op != OP_EQ)).long()
        flush = tb & (cur_cnt > 0)
        emit(flush)
        nfl = nfl + flush.long()

        # ---- carry update (engine_xla.py:339-350) ----
        stalled = tb & (i == 0) & (j == 0)
        wfail = act & ~found
        ok = act & ~wfail & ~stalled
        failed = (failed | torch.where(wfail, FAIL_TB, 0).to(torch.int32)
                  | torch.where(stalled, FAIL_STALL, 0).to(torch.int32))
        ed = ed + torch.where(ok, wed - dd, 0)
        ref_idx = ref_idx + torch.where(ok, i, 0)
        read_idx = read_idx + torch.where(ok, j, 0)
        done = done | wfail | stalled | (read_idx >= plen)
        counts[w] = torch.where(ok, nfl, 0).to(torch.int32)
        entries[w] = ent[:NE]

    incomplete = (failed == 0) & (read_idx < plen)
    failed = failed | torch.where(incomplete, FAIL_INCOMPLETE, 0).to(
        torch.int32)
    return BatchResult(ed.to(torch.int32), failed, entries, counts)
