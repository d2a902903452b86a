"""Device-side CIGAR token coding, byte-identical to scrooge_tpu/ops/tokens.py.

Port of ``tokenize_u8``, ``compact_tokenize`` and ``compact_tokens``
(scrooge_tpu/ops/tokens.py:41-148) in torch ops, so that
``scrooge_tpu.native.format_tokens`` / ``tokens_to_runs`` decode the
port's tokens unchanged. Token format (one uint8, tag = tok >> 5,
val = tok & 31):

  tag 0      a bare '='-run of length val (1..31)
  tag 1/2/3  an X/I/D edit preceded by an '='-run of length val (0..31)
  tag 4      extend the immediately preceding edit run by val (1..31)

Only engine_xla's dense row layout exists in the port, so there is no
sparse-row branch. ``lane_tokens`` is the route the API takes: on the CPU
the torch chain (``lane_tokens_plain``), on a card the hand-written kernel
``csrc/genasm_tokens.cu``, which gives the same bytes with no (rows x
lanes) temporary and no scan.
"""

from __future__ import annotations

import torch

from . import _cuda
from .compact import compact_flat, dense_valid, entries_to_u8

TAG_EXT = 4
VAL_BITS = 5
VAL_MASK = (1 << VAL_BITS) - 1


def supports(cfg) -> bool:
    """Token coding is valid when every run count fits the 5-bit val."""
    return cfg.tb_limit <= VAL_MASK


def tokenize_u8(comp: torch.Tensor) -> torch.Tensor:
    """Compacted uint8 runs (cap, B) -> token candidates (2*cap, B) uint8;
    slot g emits rows 2g and 2g+1, and 0 marks no token."""
    cap, B = comp.shape
    c = comp.to(torch.int16)
    op = c >> 6
    cnt = c & 63
    valid = c != 0  # '=' runs are their count (>= 1); edits have op bits
    is_edit = valid & (op != 0)
    zero_row = torch.zeros((1, B), dtype=c.dtype, device=c.device)
    nxt = torch.cat([c[1:], zero_row])
    nxt_edit = (nxt >> 6) != 0
    prv = torch.cat([zero_row, c[:-1]])
    prev_eq_cnt = torch.where((prv != 0) & ((prv >> 6) == 0), prv & 63, 0)
    bare_eq = valid & (op == 0) & ~nxt_edit
    tok_a = torch.where(is_edit, (op << VAL_BITS) | prev_eq_cnt,
                        torch.where(bare_eq, cnt, 0))
    tok_b = torch.where(is_edit & (cnt > 1),
                        (TAG_EXT << VAL_BITS) | (cnt - 1), 0)
    return torch.stack([tok_a, tok_b], 1).reshape(2 * cap, B).to(
        torch.uint8)


def compact_tokenize(entries: torch.Tensor, counts: torch.Tensor, cap: int,
                     ne3c: int = 0):
    """Dense engine rows -> (token candidates (2*cap, B), run totals,
    token totals). ne3c > 0 first slices each window to its first ne3c
    rows (a bound >= the batch's most runs in one window)."""
    maxw, ne, b = entries.shape
    e8 = entries_to_u8(entries)
    if ne3c and ne3c < ne:
        e8 = e8[:, :ne3c]
        ne = ne3c
    valid = dense_valid(counts, ne)
    comp, totals = compact_flat(e8.reshape(maxw * ne, b),
                                valid.reshape(maxw * ne, b), cap)
    toks = tokenize_u8(comp)
    tok_totals = (toks != 0).sum(0, dtype=torch.int32)
    return toks, totals, tok_totals


def compact_tokens(toks: torch.Tensor, capT: int) -> torch.Tensor:
    """Compact the token candidates and return them lane-major (B, capT),
    the layout the host decoder walks."""
    out, _ = compact_flat(toks, toks != 0, capT)
    return out.T.contiguous()


def lane_tokens_plain(entries: torch.Tensor, counts: torch.Tensor, cap: int,
                      ne3c: int = 0):
    """Dense engine rows -> (tokens (B, 2*cap) uint8 lane-major, each lane's
    tokens first and zeros after them; token totals (B,) int32), through
    compact_tokenize and compact_tokens. ``cap`` is at least the largest
    lane's run total, so no lane overflows; ne3c as in compact_tokenize."""
    toks, _, lane_tot = compact_tokenize(entries, counts, cap, ne3c)
    return compact_tokens(toks, 2 * cap), lane_tot


def lane_tokens(entries: torch.Tensor, counts: torch.Tensor, cap: int,
                ne3c: int = 0):
    """lane_tokens_plain's result. CPU tensors take the plain version and
    CUDA tensors the kernel (``_cuda.GENASM_TOKENS``, which reads every row
    below a window's count and needs no ne3c, and refuses more than 64
    rows a window, tb_limit > 31); there is no fallback between the
    two."""
    dev = entries.device
    if dev.type == "cpu":
        return lane_tokens_plain(entries, counts, cap, ne3c)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    wcap, ne, B = entries.shape
    if (entries.dtype != torch.int16 or counts.dtype != torch.int32
            or tuple(counts.shape) != (wcap, B) or counts.device != dev
            or not entries.is_contiguous() or not counts.is_contiguous()):
        raise ValueError("lane_tokens takes contiguous (wcap, ne, B) int16 "
                         "entries and (wcap, B) int32 counts on one device")
    out = torch.empty((B, 2 * cap), dtype=torch.uint8, device=dev)
    lane_tot = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _cuda.GENASM_TOKENS.launch(
            0, entries.data_ptr(), counts.data_ptr(), wcap, ne, B, 2 * cap,
            out.data_ptr(), lane_tot.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return out, lane_tot
