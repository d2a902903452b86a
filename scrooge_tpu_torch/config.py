"""Algorithm configuration ("knobs").

The port's own copy of ``scrooge_tpu/config.py``: the same fields,
defaults and validation, so a configuration maps across the two packages
with ``AlignConfig(**dataclasses.asdict(other))``.

The reference's compile-time knobs (W, K, O, STORE_ENTRIES_NOT_EDGES,
DISCARD_ENTRIES_NOT_USED_BY_TRACEBACK, EARLY_TERMINATION;
genasm_cpu.cpp:1-35) are runtime fields of a frozen, hashable dataclass:

 - ``W``: window width (text and pattern chunk size per DP window).
 - ``K``: maximum edit distance searched per window (DP rows = K+1).
 - ``O``: window overlap; only the first ``W - O`` text/pattern characters
   of each window's traceback are kept (TB_LIMIT, genasm_cpu.cpp:50).
 - ``store_entries_not_edges`` (SENE) and
   ``discard_entries_not_used_by_traceback`` (DENT) change the memory
   layout only; outputs are bit-identical either way. The CUDA kernel
   always stores entries with DENT columns; the scalar oracle honours both.
 - ``early_termination`` (ET) stops the d-loop at the first row whose
   column-0 entry signals a full-pattern match; without it every window
   fills rows 0..K. Output-invariant. The plain engine and every CUDA
   kernel honour it (the kernels as a template parameter).

``batch_tile`` is the number of pairs per engine call. ``backend``,
``tb_cap_override``, ``retry_escalation`` and ``margin_override`` are the
JAX package's engine knobs, kept so that configurations map across; the
port accepts ``backend`` "auto" or "pyref" and reads none of the others.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Runtime equivalent of the reference's compile-time knob block."""

    W: int = 64
    K: int = 64
    O: int = 33

    store_entries_not_edges: bool = True
    discard_entries_not_used_by_traceback: bool = True
    early_termination: bool = True

    batch_tile: int = 1024
    backend: str = "auto"  # "auto" | "xla" | "pallas" | "pyref"
    tb_cap_override: int = 0
    retry_escalation: bool = True
    margin_override: int = 0

    def __post_init__(self):
        if self.W < 2:
            raise ValueError("W must be >= 2")
        if not (0 <= self.O < self.W):
            raise ValueError("O must satisfy 0 <= O < W")
        if self.K < 1:
            raise ValueError("K must be >= 1")
        if self.batch_tile % 128 != 0:
            raise ValueError("batch_tile must be a multiple of 128 (TPU lanes)")
        if not 0 <= self.tb_cap_override <= self.K:
            raise ValueError("tb_cap_override must be in [0, K]")
        if not 0 <= self.margin_override <= 64:
            raise ValueError("margin_override must be in [0, 64]")

    # ---- derived quantities (names follow genasm_cpu.cpp:44-84) ----

    @property
    def tb_limit(self) -> int:
        """Max text/pattern chars traced back per window (W - O)."""
        return self.W - self.O

    @property
    def columns(self) -> int:
        """Columns of the stored R table: W-O+1 (DENT)."""
        return self.W - self.O + 1

    @property
    def rows(self) -> int:
        return self.K + 1

    def max_windows(self, max_read_len: int) -> int:
        """Static bound on the number of DP windows for a read length.

        A window consumes up to tb_limit pattern chars, but fewer when
        deletions advance the text cursor to tb_limit first, so ~34 %
        headroom (enough up to ~25 % deletions) plus slack is budgeted.
        Lanes that still run out are flagged failed and retried.
        """
        if max_read_len <= 0:
            return 1
        return int(math.ceil(max_read_len * 1.34 / max(1, self.tb_limit))) + 4
