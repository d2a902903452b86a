"""2-bit sequence packing, 16 bases per 32-bit word.

Port of ``engine_pallas.pack_2bit`` / ``pack_2bit_host``
(scrooge_tpu/ops/engine_pallas.py:209-238): char k of a word sits in bits
[2k, 2k+2). Host packing goes through the port's ``native`` helpers, whose
words are byte-identical to what the JAX package uploads.

Words travel as ``int32`` tensors holding the uint32 bit pattern: torch's
unsigned 32-bit dtype cannot shift on the CPU. A right shift of such a word
sign-extends, but every reader masks the two bits it extracts, so the
codes come out right.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native

CHARS_PER_WORD = 16


def pack_2bit(codes: torch.Tensor) -> torch.Tensor:
    """(..., T) 2-bit codes -> (..., ceil(T/16)) int32 words (uint32 bits)."""
    T = codes.shape[-1]
    Tw = -(-T // CHARS_PER_WORD)
    pad = Tw * CHARS_PER_WORD - T
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    grouped = codes.reshape(codes.shape[:-1] + (Tw, CHARS_PER_WORD))
    shifts = torch.arange(CHARS_PER_WORD, device=codes.device) * 2
    words = (grouped.to(torch.int64) << shifts).sum(-1)
    # two's-complement view of the uint32 value
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def encode_pack_host(seqs, width: int) -> np.ndarray:
    """ASCII rows -> (len(seqs), ceil(width/16)) uint32 words in one native
    pass. Raises ValueError on non-ACGT and RuntimeError when the native
    helpers cannot be built."""
    return native.encode_pack_strs(list(seqs), width)


def to_device(words: np.ndarray, device) -> torch.Tensor:
    """uint32 host words -> int32 tensor of the same bits on ``device``."""
    host = torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
    return host.to(device)


def unpack_codes(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """2-bit codes at char positions ``pos`` (int64) of flat ``words``."""
    w = words[pos >> 4].to(torch.int64)
    return (w >> ((pos & 15) * 2)) & 3
