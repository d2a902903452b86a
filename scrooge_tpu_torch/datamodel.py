"""Data model: Python equivalents of the reference's core types.

The port's own copy of ``scrooge_tpu/datamodel.py`` (the reference's
util.hpp:11-46: Sequence_t, Genome_t, CandidateLocation_t, Read_t,
Alignment_t).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class Sequence:
    """One FASTA record (util.hpp:11-14), as ``io.read_fasta`` returns it."""

    description: str
    content: str


@dataclass
class Genome:
    """Concatenated multi-chromosome reference (util.hpp:16-19).

    ``chromosome_starts`` maps chromosome description -> offset of that
    chromosome within ``content`` (util.cpp:96-108).
    """

    content: str = ""
    chromosome_starts: Dict[str, int] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.content)


@dataclass
class CandidateLocation:
    """A seed hit: where a read may align in the reference (util.hpp:22-30)."""

    read_description: str = ""
    chromosome: str = ""
    start_in_chromosome: int = 0
    start_in_reference: int = 0
    start_of_aligned_region: int = 0
    size_of_aligned_region: int = 0
    strand: bool = True


@dataclass
class Read:
    description: str
    content: str
    locations: List[CandidateLocation] = field(default_factory=list)


@dataclass
class Alignment:
    """Result type (util.hpp:38-41): extended CIGAR + semiglobal edit distance."""

    cigar: str
    edit_distance: int


class PackedAlignments:
    """Batch result in packed-run form, without CIGAR strings.

      runs[run_offsets[i] : run_offsets[i+1]] are pair i's CIGAR runs in
      order, each uint16 ``op << 12 | count`` with op 0:'=' 1:'X' 2:'I'
      3:'D' and count <= 4095 (runs are per window, never merged across
      windows, as in the reference, genasm_cpu.cpp:411-438).
    """

    OPS = "=XID"

    def __init__(self, edit_distances, run_offsets, runs):
        self.edit_distances = edit_distances  # int32 (n,)
        self.run_offsets = run_offsets        # int64 (n+1,)
        self.runs = runs                      # uint16 (total,)

    def __len__(self) -> int:
        return len(self.edit_distances)

    def pair_runs(self, i: int):
        return self.runs[self.run_offsets[i] : self.run_offsets[i + 1]]

    def cigar(self, i: int) -> str:
        return "".join(f"{int(e) & 0x0FFF}{self.OPS[int(e) >> 12]}"
                       for e in self.pair_runs(i))

    def to_alignments(self) -> List[Alignment]:
        return [Alignment(cigar=self.cigar(i),
                          edit_distance=int(self.edit_distances[i]))
                for i in range(len(self))]
