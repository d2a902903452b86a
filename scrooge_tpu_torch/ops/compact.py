"""Device-side result compaction: per-window run rows -> per-pair run lists.

Port of engine_xla.batch_meta, _entries_to_u8, _dense_valid and
compact_entries[_u8] (scrooge_tpu/ops/engine_xla.py:446-571). The JAX
package routes rows with log-shift passes (_compact_flat_logshift,
:482-522) only because gathers and scatters are slow on a TPU; here the
same compaction is an exclusive prefix sum plus one ``scatter_``.

Runs are int16 on the device (3 << 12 | 4095 < 2^15). Unsigned torch
dtypes cannot shift or scatter on the CPU, so arithmetic stays in int16
and only the u8 results are stored as uint8.
"""

from __future__ import annotations

import torch

from .engine import ENTRY_CNT_MASK, ENTRY_OP_SHIFT, BatchResult


def batch_meta(res: BatchResult) -> torch.Tensor:
    """(5, B) int32: edit distance, run total, failure bits, most runs in
    one window, windows used (index of the last window with runs, +1)."""
    counts = res.counts
    maxw = counts.shape[0]
    wiota = torch.arange(1, maxw + 1, dtype=torch.int32,
                         device=counts.device)[:, None]
    return torch.stack([
        res.edit_distance.to(torch.int32),
        counts.sum(0, dtype=torch.int32),
        res.failed.to(torch.int32),
        counts.amax(0).to(torch.int32),
        torch.where(counts > 0, wiota, 0).amax(0).to(torch.int32),
    ])


def dense_valid(counts: torch.Tensor, ne: int) -> torch.Tensor:
    """(MAXW, NE, B) mask: row e of window w is a run iff e < counts[w]."""
    e = torch.arange(ne, dtype=counts.dtype, device=counts.device)
    return e[None, :, None] < counts[:, None, :]


def entries_to_u8(entries: torch.Tensor) -> torch.Tensor:
    """int16 runs (op << 12 | count) -> uint8 (op << 6 | count); exact when
    every count fits 6 bits (tb_limit <= 63). Bit-identical to the JAX
    repack for any input: both keep the low 8 bits."""
    ops = entries >> ENTRY_OP_SHIFT
    cnts = entries & ENTRY_CNT_MASK
    return ((ops << 6) | cnts).to(torch.uint8)


def compact_flat(flat: torch.Tensor, valid: torch.Tensor, cap: int):
    """Move each lane's valid rows, in order, to a dense prefix.

    flat, valid: (L, B). Returns (out (cap, B) with rows >= the lane's
    total zero, totals (B,) int32). Rows past ``cap`` are dropped."""
    L, B = flat.shape
    if L == 0:
        return (torch.zeros((cap, B), dtype=flat.dtype, device=flat.device),
                torch.zeros(B, dtype=torch.int32, device=flat.device))
    vcum = torch.cumsum(valid, 0, dtype=torch.int32)
    totals = vcum[-1].clone()
    # slot of a valid row = valid rows before it; the rest go to row cap,
    # a sink dropped below
    dest = torch.where(valid & (vcum <= cap), vcum - 1, cap).to(torch.int64)
    out = torch.zeros((cap + 1, B), dtype=flat.dtype, device=flat.device)
    out.scatter_(0, dest, flat)
    return out[:cap], totals


def compact_entries(entries: torch.Tensor, counts: torch.Tensor, cap: int):
    """(MAXW, NE, B) int16 runs -> ((cap, B) int16 per-pair runs, totals)."""
    maxw, ne, b = entries.shape
    valid = dense_valid(counts, ne).reshape(maxw * ne, b)
    return compact_flat(entries.reshape(maxw * ne, b), valid, cap)


def compact_entries_u8(entries: torch.Tensor, counts: torch.Tensor,
                       cap: int):
    """compact_entries on the uint8 repack (tb_limit <= 63)."""
    maxw, ne, b = entries.shape
    valid = dense_valid(counts, ne).reshape(maxw * ne, b)
    return compact_flat(entries_to_u8(entries).reshape(maxw * ne, b), valid,
                        cap)
