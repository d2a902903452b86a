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
  (scrooge_tpu/ops/engine_xla.py:105-443), which the JAX package runs for
  every W its Pallas kernel cannot hold (W > 256). On the card that is
  ``csrc/genasm_windows_wide.cu``: five to 32 words (W = 257..2048), a
  group of G threads a pair, thread t holding word t of every bitvector.
  ``align_windows_plain`` below is their lane-batched lockstep counterpart
  in torch ops. The CPU path and the tests use it, and on the card it is
  what every kernel is held against.

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

Bitvectors are NW = ceil(W/64) 64-bit words, word 0 the lowest, W <= 2048.
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

# a run is stored as op << 12 | count, and its count (at most 2*tb_limit
# a window) must stay below 2^12 (engine_xla.py:48-49): W <= 2048
MAX_W = 2048
WORD = 64
# words per bitvector of the kernels: genasm_windows1.cu one,
# genasm_windows.cu up to four, genasm_windows_wide.cu the rest
MULTIWORD_MAX_NW = 4
# share of the card's free memory a call's R and forefront scratch may take
SCRATCH_SHARE = 0.75


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
            f"W={cfg.W}: a window's runs are stored as op << 12 | count, "
            f"whose 12-bit run count bounds W to {MAX_W} "
            "(engine_xla.py:48-49)")


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
                  text_base, text_len, pattern_words, pattern_len, *,
                  budget_bytes: Optional[int] = None) -> BatchResult:
    """Align B pairs over exactly ``max_windows`` windows.

    text_words: int32 packed words, any shape, read flat; lane b's text
    char k is flat char ``text_base[b] + k`` (int64) and exists for
    k < text_len[b]. For read mapping, text_words is the device-resident
    packed genome and text_base the candidate starts (64-bit: genomes reach
    2^32 bases), text_len pre-clamped by the caller; align_batch covers
    unstructured pairs. pattern_words: (B, Pw) int32 packed rows;
    pattern_len (B,) int32.

    CPU tensors take the plain version. CUDA tensors launch the kernel;
    there is no fallback between the two. ``budget_bytes`` bounds one
    launch's scratch on the card (_align_windows_cuda); the plain version
    has none.
    """
    check_config(cfg)
    dev = pattern_words.device
    if dev.type == "cpu":
        return align_windows_plain(cfg, max_windows, text_words, text_base,
                                   text_len, pattern_words, pattern_len)
    if dev.type == "cuda":
        return _align_windows_cuda(cfg, max_windows, text_words, text_base,
                                   text_len, pattern_words, pattern_len,
                                   budget_bytes=budget_bytes)
    raise ValueError(f"unsupported device {dev}")


def align_batch(cfg: AlignConfig, max_windows: int, text_words, text_len,
                pattern_words, pattern_len, *,
                budget_bytes: Optional[int] = None) -> BatchResult:
    """Unstructured pairs: text_words (B, Tw), pattern_words (B, Pw)."""
    B, Tw = text_words.shape
    base = torch.arange(B, dtype=torch.int64, device=text_words.device)
    return align_windows(cfg, max_windows, text_words, base * (Tw * 16),
                         text_len, pattern_words, pattern_len,
                         budget_bytes=budget_bytes)


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
    word (W <= 64), genasm_windows.cu for two to four, and
    genasm_windows_wide.cu for five to 32 (W = 257..2048)."""
    nw = num_words(cfg.W)
    if nw == 1:
        return _cuda.GENASM_WINDOWS1
    if nw <= MULTIWORD_MAX_NW:
        return _cuda.GENASM_WINDOWS
    return _cuda.GENASM_WINDOWS_WIDE


def group_size(W: int) -> int:
    """Threads a pair of genasm_windows_wide.cu: the power of two >= NW,
    at least 8 (8, 16 or 32)."""
    return max(8, 1 << (num_words(W) - 1).bit_length())


def pairs_per_warp(cfg: AlignConfig) -> int:
    """Pairs a warp of the config's kernel runs: 32 at one thread a pair,
    32 / G for the wide kernel. A launch's lanes come in these units."""
    return (32 if num_words(cfg.W) <= MULTIWORD_MAX_NW
            else 32 // group_size(cfg.W))


def scratch_words(cfg: AlignConfig, B: int):
    """int64 words of the kernel's (R, forefront) scratch for B lanes.

    R: columns i < W-O+1 (DENT). The one-word kernel stores one word a
    column and keeps its forefront in registers (no scratch). The
    multiword kernels store only the MSB-aligned words that hold bits
    [O-1, W), which the traceback reads: NW - max(O-1, 0) // 64 of them.
    genasm_windows.cu keeps rows d <= K+1 (the row pair at d = K computes
    row K+1) in blocks of 32 lanes, and a forefront of W+17 columns of NW
    words (ff_cols: 0..W and the top fill batch's columns above W).
    genasm_windows_wide.cu fills one row a pass: rows d <= K, and a
    forefront of the W+1 columns, each pair's own.
    """
    nw = num_words(cfg.W)
    if nw == 1:
        return (cfg.K + 2) * cfg.columns * (-(-B // 32) * 32), 0
    stored = nw - max(cfg.O - 1, 0) // WORD
    if nw <= MULTIWORD_MAX_NW:
        lanes = -(-B // 32) * 32
        return ((cfg.K + 2) * stored * cfg.columns * lanes,
                (cfg.W + 17) * nw * lanes)
    return (cfg.K + 1) * stored * cfg.columns * B, (cfg.W + 1) * nw * B


def launch_chunks(cfg: AlignConfig, B: int, budget_bytes: int):
    """Lane ranges [lo, hi) that split B lanes into launches whose scratch
    (scratch_words) takes at most ``budget_bytes`` each: as few launches
    as the budget allows, every one but the last a whole number of warps.
    Raises MemoryError when not even one warp's pairs fit."""
    unit = pairs_per_warp(cfg)
    per_unit = 8 * sum(scratch_words(cfg, unit))
    units = int(budget_bytes) // per_unit
    if units < 1:
        raise MemoryError(
            f"W={cfg.W} K={cfg.K} O={cfg.O}: one warp's {unit} pairs need "
            f"{per_unit} bytes of R and forefront scratch, more than the "
            f"{int(budget_bytes)} bytes available")
    step = units * unit
    return [(lo, min(lo + step, B)) for lo in range(0, B, step)]


def free_bytes(dev) -> int:
    """Bytes of the card's memory torch could hand out now: the free
    memory cudaMemGetInfo reports and what torch's caching allocator
    holds unused."""
    free, _ = torch.cuda.mem_get_info(dev)
    return free + (torch.cuda.memory_reserved(dev)
                   - torch.cuda.memory_allocated(dev))


def _align_windows_cuda(cfg, max_windows, text_words, text_base, text_len,
                        pattern_words, pattern_len,
                        budget_bytes: Optional[int] = None) -> BatchResult:
    """Kernel wrapper: allocates outputs, then launches once for each lane
    range of launch_chunks, with that range's scratch; ``budget_bytes``
    (default SCRATCH_SHARE of free_bytes) bounds one launch's scratch. A range after
    the first writes its runs to its own buffers, which are copied into
    place; the split changes no output."""
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
    if budget_bytes is None:
        budget_bytes = int(SCRATCH_SHARE * free_bytes(dev))
    chunks = launch_chunks(cfg, B, budget_bytes) if B else []
    for lo, hi in chunks:
        whole = (lo, hi) == (0, B)
        ent = entries if whole else torch.zeros(
            (max_windows, NE, hi - lo), dtype=torch.int16, device=dev)
        cnt = counts if whole else torch.empty(
            (max_windows, hi - lo), dtype=torch.int32, device=dev)
        scratch = [torch.empty(n, dtype=torch.int64, device=dev)
                   for n in scratch_words(cfg, hi - lo) if n]
        with torch.cuda.device(dev):
            kernel.launch(num_words(cfg.W), text_words.data_ptr(),
                          text_words.numel(), text_base[lo:].data_ptr(),
                          text_len[lo:].data_ptr(),
                          pattern_words[lo:].data_ptr(),
                          int(pattern_words.shape[1]),
                          pattern_len[lo:].data_ptr(), hi - lo, cfg.W,
                          cfg.K, cfg.O, int(max_windows),
                          *(t.data_ptr() for t in scratch),
                          ed[lo:].data_ptr(), failed[lo:].data_ptr(),
                          ent.data_ptr(), cnt.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
        # back to torch's allocator before the next range takes its own:
        # it reuses the memory only for work queued after this launch
        del scratch
        if not whole:
            entries[:, :, lo:hi] = ent
            counts[:, lo:hi] = cnt
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

    def shl(self, v: torch.Tensor, k: int) -> torch.Tensor:
        """v << k across the words (k >= 1), not masked: bits shifted past
        W are left to the caller, whose operands mask them."""
        q, r = divmod(k, WORD)
        out = torch.zeros_like(v)
        if q >= self.nw:
            return out
        lo = v[..., : self.nw - q, :]
        if r == 0:
            out[..., q:, :] = lo
            return out
        out[..., q:, :] = lo << r
        # the top r bits of the word below, as the low r bits
        out[..., q + 1:, :] |= (lo[..., :-1, :] >> (WORD - r)) & ((1 << r) - 1)
        return out

    def scan_row(self, A: torch.Tensor, Bv: torch.Tensor) -> torch.Tensor:
        """Every column of one DP row from its column maps.

        Column i of a row is f_i(column i+1) with f_i(r) = ((r << 1) &
        A[i]) | Bv[i], A and Bv (W+1, NW, B) and A[W] = 0, so column i is
        Bv of f_i o f_i+1 o ... o f_W. A composition of k such maps is
        r -> ((r << k) & A') | Bv' again, so log2(W+1) doubling steps
        compose every suffix at once (a Hillis-Steele scan): step k
        composes each i with i+k. Returns the columns (W+1, NW, B)."""
        k, n = 1, A.shape[0]
        while k < n:
            outer = A[:-k]
            A = torch.cat([self.shl(A[k:], k) & outer, A[-k:]])
            Bv = torch.cat([(self.shl(Bv[k:], k) & outer) | Bv[:-k],
                            Bv[-k:]])
            k *= 2
        return Bv

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
        # (W+1, 1, B): column i >= n
        is_start = (col[:, None] >= n[None, :])[:, None, :]

        # ---- DP fill (pyref.genasm_dc) ----
        found = ~act
        wed = zeros(B)
        rows = []  # R[d]: the stored DENT columns of row d, (COLS, NW, B)
        probe = (m - 1).clamp(min=0)
        ff = None
        zero = torch.zeros_like(pmi[:1])
        for d in range(K + 1):
            # start columns i >= n: ones at d == 0, ones << d after; a
            # start column's map is the constant, A = 0
            start = bv.const(ones_shifted(W, d)).expand(NW, B)
            if d == 0:  # (shl1(right) | PM[text[i]])
                A = bv.full.expand(W, NW, B)
                Bv = pmi
            else:
                # sub & ins & del for every column at once, from row d-1:
                # (R[d-1][i+1] << 1) & (R[d-1][i] << 1) & R[d-1][i+1];
                # (shl1(right) | PM[text[i]]) & x
                ins = bv.shl1(ff)
                A = ins[1:] & ins[:-1] & ff[1:]
                Bv = pmi & A
            A = torch.where(is_start, 0, torch.cat([A, zero]))
            Bv = torch.where(is_start, start, torch.cat([Bv, zero]))
            ff = bv.scan_row(A, Bv)  # (W+1, NW, B), column-major
            right = ff[0]
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
