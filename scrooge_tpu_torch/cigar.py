"""CIGAR parsing and the semantic validation oracle.

The port's own copy of the parts of ``scrooge_tpu/cigar.py`` it calls:
``parse_cigar`` (packed output of retried pairs) and ``validate_cigar`` /
``is_valid_cigar`` (the reference's test oracle, tests.cu:27-169).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Tuple

_RUN_RE = re.compile(r"(\d+)([=XIDM])")


@dataclass
class CigarError(Exception):
    message: str

    def __str__(self):
        return self.message


def parse_cigar(cigar: str) -> List[Tuple[int, str]]:
    """Parse an extended CIGAR into (count, op) runs; validates the format
    as cigarFormatCorrect does (tests.cu:27-60)."""
    runs: List[Tuple[int, str]] = []
    pos = 0
    for match in _RUN_RE.finditer(cigar):
        if match.start() != pos:
            raise CigarError(f"CIGAR had bad format at offset {pos}: {cigar!r}")
        count = int(match.group(1))
        if count == 0:
            raise CigarError("CIGAR cannot contain edits with count 0")
        runs.append((count, match.group(2)))
        pos = match.end()
    if pos != len(cigar):
        raise CigarError(f"CIGAR had bad format at offset {pos}: {cigar!r}")
    return runs


def validate_cigar(cigar: str, edit_distance: int, reference: str, read: str,
                   start_in_reference: int = 0) -> None:
    """Semantic CIGAR oracle (validateCigarString, tests.cu:106-169);
    raises CigarError on any violation: the read is covered exactly, the
    reference stays in bounds, '='/'X' runs agree with the sequences, and
    the edits counted equal the reported edit distance."""
    runs = parse_cigar(cigar)
    i, j = start_in_reference, 0
    for count, op in runs:
        if op == "I":
            j += count
        elif op == "D":
            i += count
        else:
            i += count
            j += count
    if j < len(read):
        raise CigarError("CIGAR didn't cover entire read")
    if j > len(read):
        raise CigarError("CIGAR went out of bounds of read")
    if i > len(reference):
        raise CigarError("CIGAR went out of bounds of reference")

    i, j, edits = start_in_reference, 0, 0
    for count, op in runs:
        if op == "I":
            j += count
            edits += count
        elif op == "D":
            i += count
            edits += count
        else:
            for _ in range(count):
                same = reference[i].upper() == read[j].upper()
                if op == "X" and same:
                    raise CigarError(f"CIGAR contains 'X' but reference[{i}] "
                                     f"and read[{j}] match")
                if op == "=" and not same:
                    raise CigarError(f"CIGAR contains '=' but reference[{i}] "
                                     f"and read[{j}] mismatch")
                if op == "M" and reference[i] != read[j]:
                    edits += 1
                i += 1
                j += 1
            if op == "X":
                edits += count
    if edits != edit_distance:
        raise CigarError(f"CIGAR has {edits} edits, while the reported edit "
                         f"distance is {edit_distance}")


def is_valid_cigar(cigar: str, edit_distance: int, reference: str, read: str,
                   start_in_reference: int = 0) -> bool:
    try:
        validate_cigar(cigar, edit_distance, reference, read, start_in_reference)
        return True
    except CigarError:
        return False
