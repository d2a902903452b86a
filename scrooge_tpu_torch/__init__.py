"""scrooge_tpu_torch — the GenASM/Scrooge aligner on PyTorch and CUDA.

The port of ``scrooge_tpu`` (JAX/Pallas on a TPU) to an NVIDIA H100: the
same two interfaces, its own copies of the configuration, data model,
scalar oracle and native host helpers, and the same results bit for bit
for W <= 2048. The window engine is a hand-written CUDA kernel for sm_90a
(``csrc/genasm_windows1.cu`` for one-word bitvectors,
``csrc/genasm_windows.cu`` for two and three words,
``csrc/genasm_windows_wide.cu`` for four to 32) beside a plain torch
version that CPU tensors run. This package imports ``torch``, never ``jax``
and nothing of ``scrooge_tpu``.
"""

from .api import (AlignmentError, PreparedGenome, align_all, align_pairs,
                  align_reads, prepare_genome)
from .config import AlignConfig
from .datamodel import (Alignment, CandidateLocation, Genome,
                        PackedAlignments, Read)

__all__ = [
    "AlignConfig",
    "Alignment",
    "AlignmentError",
    "CandidateLocation",
    "Genome",
    "PackedAlignments",
    "PreparedGenome",
    "Read",
    "align_all",
    "align_pairs",
    "align_reads",
    "prepare_genome",
]
