"""scrooge_tpu_torch — the GenASM/Scrooge aligner on PyTorch and CUDA.

The port of ``scrooge_tpu`` (JAX/Pallas on a TPU) to an NVIDIA H100: the
same two interfaces, the same configuration and data model (taken from
``scrooge_tpu`` unchanged), and the same results bit for bit. The window
engine is a hand-written CUDA kernel for sm_90a (``csrc/genasm_windows.cu``)
beside a plain torch version that CPU tensors run. This package imports
``torch`` and never ``jax``.
"""

from scrooge_tpu.config import AlignConfig
from scrooge_tpu.datamodel import Alignment, CandidateLocation, Genome, Read

from .api import (PreparedGenome, align_all, align_pairs, align_reads,
                  prepare_genome)

__all__ = [
    "AlignConfig",
    "Alignment",
    "CandidateLocation",
    "Genome",
    "PreparedGenome",
    "Read",
    "align_all",
    "align_pairs",
    "align_reads",
    "prepare_genome",
]
