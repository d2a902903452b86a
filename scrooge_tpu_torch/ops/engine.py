"""Window engine: GenASM DP fill + traceback over every window of every lane.

Port of the JAX package's window engines:

- ``engine_pallas.align_batch`` / ``align_batch_mapped`` / ``_align_scan``
  and the Pallas kernel ``slab_step_kernel`` -> ``_multi_window_kernel``
  (scrooge_tpu/ops/engine_pallas.py:367-1123), with its multiword helpers
  (``_mw_*``, ``_shl1_u32``, ``_ones_shifted_u32``, :241-334). On the card
  this is one hand-written kernel launch for all windows, one thread per
  pair, which replaces the slab loop and the per-pair segment copy:
  ``csrc/genasm_windows1.cu`` for one-word bitvectors (W <= 64) and
  ``csrc/genasm_windows.cu`` for two to four words; both set windows up
  from the packed words, fill two rows a pass and run the TPU kernel's
  level traceback. The choice follows the config alone.
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

Bitvectors are NW = ceil(W/64) 64-bit words, word 0 the lowest, W <= 256.
The plain version keeps them LSB-aligned as in the scalar oracle
(pyref.py; the multiword kernel aligns them to the top bit, as the TPU
kernel does, which changes no output): pattern position j is bit
m-1-j of the whole multiword value, the full-match probe is bit m-1, a
shift by d >= W saturates to 0, and the top word is masked to its
W - 64*(NW-1) bits. torch's unsigned dtypes cannot shift, invert or
scatter on the CPU, so the plain version keeps the words in int64: bit 63
of a word is the sign bit, every right shift is followed by ``& 1`` (an
arithmetic shift only smears copies of bit 63 above the bit read), and
left shifts wrap as two's complement.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import AlignConfig

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

MAX_W = 256
WORD = 64


class BatchResult(NamedTuple):
    edit_distance: torch.Tensor  # (B,) int32
    failed: torch.Tensor         # (B,) int32 FAIL_* bitmask, 0 = aligned
    entries: torch.Tensor        # (MAXW, NE, B) int16 runs op << 12 | count
    counts: torch.Tensor         # (MAXW, B) int32 runs per window
    # (2, B) int64 work per lane, from the plain version only: DP cells
    # filled (rows searched x (n+1) columns, summed over windows) and
    # traceback steps, what a bound on the engine's time counts. The
    # kernel does the same work and leaves this None.
    work: Optional[torch.Tensor] = None


def check_config(cfg: AlignConfig) -> None:
    if cfg.W > MAX_W:
        raise NotImplementedError(
            f"W={cfg.W}: the torch port holds a window in at most four "
            "64-bit words (W <= 256); W > 256 waits for the full-K engine, "
            "ROADMAP.md queue 1 item 8")


def num_words(W: int) -> int:
    """64-bit words per bitvector."""
    return -(-W // WORD)


def entry_rows(cfg: AlignConfig) -> int:
    """Run rows per window: a window's traceback takes at most 2*tb_limit
    steps, hence at most that many runs (engine_xla.py:114)."""
    return 2 * cfg.tb_limit + 2


def _signed(x: int) -> int:
    """A 64-bit unsigned value as the int64 holding the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def ones_shifted(W: int, d: int):
    """(ones(W) << d) & ones(W) as NW int64 words, word 0 lowest; all ones
    at d = 0 and 0 from d = W on (engine_pallas._ones_shifted_u32)."""
    v = ((1 << W) - 1) & ~((1 << min(d, W)) - 1)
    return [_signed((v >> (WORD * k)) & ((1 << WORD) - 1))
            for k in range(num_words(W))]


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


def window_kernel(cfg: AlignConfig):
    """The CUDA kernel the config launches: genasm_windows1.cu for one
    word (W <= 64), genasm_windows.cu for two to four."""
    return (_cuda.GENASM_WINDOWS1 if num_words(cfg.W) == 1
            else _cuda.GENASM_WINDOWS)


def scratch_words(cfg: AlignConfig, B: int):
    """int64 words of the kernel's R and forefront scratch for B lanes.

    R: rows d <= K+1 (the row pair at d = K computes row K+1), columns
    i < W-O+1 (DENT), in blocks of 32 lanes. The one-word kernel stores
    one word a column and keeps its forefront in registers (no scratch).
    The multiword kernel stores only the MSB-aligned words that hold bits
    [O-1, W), which the traceback reads: NW - max(O-1, 0) // 64 of them;
    its forefront holds W+17 columns of NW words (genasm_windows.cu
    ff_cols: 0..W and the top fill batch's columns above W).
    """
    nw, lanes = num_words(cfg.W), -(-B // 32) * 32
    if nw == 1:
        return (cfg.K + 2) * cfg.columns * lanes, 0
    stored = nw - max(cfg.O - 1, 0) // WORD
    return ((cfg.K + 2) * stored * cfg.columns * lanes,
            (cfg.W + 17) * nw * lanes)


def _align_windows_cuda(cfg, max_windows, text_words, text_base, text_len,
                        pattern_words, pattern_len) -> BatchResult:
    """Kernel wrapper: allocates outputs and scratch, launches once."""
    _check_inputs(text_words, text_base, text_len, pattern_words,
                  pattern_len)
    kernel = window_kernel(cfg)
    dev = pattern_words.device
    B = int(pattern_len.shape[0])
    NE = entry_rows(cfg)
    ed = torch.empty(B, dtype=torch.int32, device=dev)
    failed = torch.empty(B, dtype=torch.int32, device=dev)
    entries = torch.zeros((max_windows, NE, B), dtype=torch.int16,
                          device=dev)
    counts = torch.empty((max_windows, B), dtype=torch.int32, device=dev)
    r_words, ff_words = scratch_words(cfg, B)
    R = torch.empty(r_words, dtype=torch.int64, device=dev)
    scratch = (R.data_ptr(),)
    if ff_words:
        ff = torch.empty(ff_words, dtype=torch.int64, device=dev)
        scratch += (ff.data_ptr(),)
    with torch.cuda.device(dev):
        kernel.launch(num_words(cfg.W), text_words.data_ptr(),
                      text_words.numel(), text_base.data_ptr(),
                      text_len.data_ptr(), pattern_words.data_ptr(),
                      int(pattern_words.shape[1]), pattern_len.data_ptr(),
                      B, cfg.W, cfg.K, cfg.O, int(max_windows), *scratch,
                      ed.data_ptr(), failed.data_ptr(), entries.data_ptr(),
                      counts.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
    return BatchResult(ed, failed, entries, counts)


class _Words:
    """Multiword int64 bitvector arithmetic of one width; vectors are
    tensors (..., NW, B), word 0 lowest (engine_pallas._mw_*)."""

    def __init__(self, W: int, dev):
        self.W, self.nw, self.dev = W, num_words(W), dev
        # ones(W): every word all ones, the top one masked to its bits
        self.full = self.const(ones_shifted(W, 0))

    def const(self, words) -> torch.Tensor:
        return torch.tensor(words, dtype=torch.int64, device=self.dev)[:, None]

    def shl1(self, v: torch.Tensor) -> torch.Tensor:
        """v << 1 across the words, masked to W bits."""
        out = v << 1
        if self.nw > 1:
            out[..., 1:, :] |= (v[..., :-1, :] >> (WORD - 1)) & 1
        return out & self.full

    @staticmethod
    def bit(v: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Bit ``pos`` (B,) of each lane's vector v (NW, B), as 0 or 1."""
        word = v.gather(0, (pos >> 6)[None])[0]
        return (word >> (pos & (WORD - 1))) & 1


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
    bv = _Words(W, dev)
    NW = bv.nw
    i64 = torch.int64

    def zeros(*shape, dtype=i64):
        return torch.zeros(shape, dtype=dtype, device=dev)

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
    cw = (torch.arange(4, dtype=i64, device=dev)[:, None] * NW
          + torch.arange(NW, dtype=i64, device=dev))  # (4, NW): c*NW + word

    ref_idx, read_idx, ed = zeros(B), zeros(B), zeros(B)
    failed = zeros(B, dtype=torch.int32)
    done = plen <= 0
    entries = zeros(max_windows, NE, B, dtype=torch.int16)
    counts = zeros(max_windows, B, dtype=torch.int32)
    work = zeros(2, B)

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
        pos = (m[:, None] - 1 - wi).clamp(min=0)  # (B, W)
        bit = torch.where(wi < m[:, None],
                          torch.ones_like(pos) << (pos & (WORD - 1)), 0)
        key = pch * NW + (pos >> 6)  # (B, W): which (c, word) holds the bit
        sel = key[:, None, None, :] == cw[None, :, :, None]
        pm = bv.full[:, 0] & ~(bit[:, None, None, :] * sel).sum(-1)  # (B,4,NW)
        # (W, NW, B): PM[text[i]]
        pmi = pm.gather(1, tch[:, :, None].expand(B, W, NW)).permute(
            1, 2, 0).contiguous()
        is_start = col[:, None] >= n[None, :]   # (W+1, B): column i >= n

        # ---- DP fill (pyref.genasm_dc) ----
        found = ~act
        wed = zeros(B)
        rows = []  # R[d]: the stored DENT columns of row d, (COLS, NW, B)
        probe = (m - 1).clamp(min=0)
        ff = None
        for d in range(K + 1):
            # start column i == n: ones at d == 0, ones << d after
            start = bv.const(ones_shifted(W, d)).expand(NW, B)
            right = start
            cols = [right]
            if d == 0:
                for i in range(W - 1, -1, -1):
                    mat = bv.shl1(right) | pmi[i]
                    right = torch.where(is_start[i], start, mat)
                    cols.append(right)
            else:
                # sub & ins & del for every column at once, from row d-1:
                # (R[d-1][i+1] << 1) & (R[d-1][i] << 1) & R[d-1][i+1]
                ins = bv.shl1(ff)
                x = ins[1:] & ins[:-1] & ff[1:]
                for i in range(W - 1, -1, -1):
                    c = (bv.shl1(right) | pmi[i]) & x[i]
                    right = torch.where(is_start[i], start, c)
                    cols.append(right)
            ff = torch.stack(cols[::-1])  # (W+1, NW, B), column-major
            rows.append(ff[:COLS])
            searching = ~found
            work[0] += torch.where(searching, n + 1, 0)
            hit = searching & (bv.bit(right, probe) == 0)
            wed = torch.where(hit, d, wed)
            found = found | hit
            if bool(found.all()):
                break
        Rf = torch.stack(rows).reshape(-1)  # [row][col][word][lane]

        # ---- traceback (pyref.genasm_tb), one step per iteration ----
        tb = act & found
        i, j, dd = zeros(B), zeros(B), wed.clone()
        cur_op = torch.full((B,), OP_NONE, dtype=i64, device=dev)
        cur_cnt, nfl = zeros(B), zeros(B)
        ent = zeros(NE + 1, B, dtype=torch.int16)  # row NE: discard sink

        def emit(flush):
            val = ((cur_op << ENTRY_OP_SHIFT) | cur_cnt).to(torch.int16)
            ent.scatter_(0, torch.where(flush, nfl, NE)[None], val[None])

        def r_bit(row, column, p):
            """Bit p of R[row][column], read one word per lane."""
            at = ((row + column.clamp(max=COLS - 1)) * NW + (p >> 6)) * B
            return (Rf[at + lane] >> (p & (WORD - 1))) & 1

        for _ in range(2 * TB):  # every step consumes text or pattern
            run = tb & (j < m) & (i < TB) & (j < TB)
            if not bool(run.any()):
                break
            work[1] += run.long()
            i_limit = i >= n
            d_limit = dd == 0
            jlast = j == m - 1  # pyref.py genasm_tb's j == m-1 case
            row = (dd - 1).clamp(min=0) * COLS
            b_j = (m - 1 - j).clamp(min=0)
            b_j1 = (m - 2 - j).clamp(min=0)
            z_ins = r_bit(row, i, b_j1) == 0
            z_del = r_bit(row, i + 1, b_j) == 0
            z_sub = r_bit(row, i + 1, b_j1) == 0
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
    return BatchResult(ed.to(torch.int32), failed, entries, counts, work)
