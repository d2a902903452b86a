"""CIGAR utilities: parsing, the semantic validation oracle, rescoring.

The port's own copy of ``scrooge_tpu/cigar.py``: ``parse_cigar`` and
``validate_cigar`` / ``is_valid_cigar`` (the reference's test oracle,
tests.cu:27-169), and the helpers of the baselines and accuracy tools:
``runs_to_cigar``, ``merge_runs``, ``affine_score`` (the affine-gap
rescoring of cpu_baseline.cpp:694-725), ``edits_in_cigar`` and
``aligned_pairs``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

VALID_OPS = "=XIDM"

_RUN_RE = re.compile(r"(\d+)([=XIDM])")
_ASCII_RUNS_RE = re.compile(r"(?:[0-9]+[=XIDM])*")


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


def runs_to_cigar(runs: List[Tuple[int, str]]) -> str:
    return "".join(f"{c}{op}" for c, op in runs)


def merge_runs(runs: List[Tuple[int, str]]) -> List[Tuple[int, str]]:
    """Merge adjacent runs of the same op (the reference does not merge
    across window boundaries; use this for normalized comparisons only)."""
    out: List[Tuple[int, str]] = []
    for count, op in runs:
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + count, op)
        else:
            out.append((count, op))
    return out


_POW10 = 10 ** np.arange(13, dtype=np.int64)
_UPPER = np.arange(128, dtype=np.uint32)
_UPPER[ord("a") : ord("z") + 1] -= 32
_I, _D, _X, _EQ, _M = (ord(c) for c in "IDX=M")


def _run_arrays(cigar: str) -> Tuple[np.ndarray, np.ndarray]:
    """(counts int64, op codes) of a CIGAR's runs; raises parse_cigar's
    CigarError on a malformed one. ASCII runs are parsed on arrays; other
    CIGARs (non-ASCII digits, counts of 13 digits or more, or an error to
    report) go through parse_cigar, their counts clipped so that no sum
    overflows (exact for starts above -2**40)."""
    if _ASCII_RUNS_RE.fullmatch(cigar):
        b = np.frombuffer(cigar.encode("ascii"), np.uint8)
        is_op = b > ord("9")
        op_at = np.flatnonzero(is_op)
        # a digit's power of ten within its count
        power = op_at[np.cumsum(is_op) - is_op] - np.arange(len(b)) - 1
        if not len(b) or power.max() <= 12:
            value = np.where(is_op, 0, (b.astype(np.int64) - ord("0"))
                             * _POW10[np.clip(power, 0, 12)])
            counts = (np.add.reduceat(
                value, np.concatenate(([0], op_at[:-1] + 1)))
                if len(op_at) else value[:0])
            if not (counts == 0).any():
                return counts, b[op_at].astype(np.uint32)
    runs = parse_cigar(cigar)
    cap = 2**62 // (len(runs) + 1)
    return (np.array([min(c, cap) for c, _ in runs], np.int64),
            np.array([ord(op) for _, op in runs], np.uint32))


def _codes(s: str) -> np.ndarray:
    try:
        return np.frombuffer(s.encode("ascii"), np.uint8).astype(np.uint32)
    except UnicodeEncodeError:
        return np.frombuffer(s.encode("utf-32-le"), np.uint32)


def _folded(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Keys equal where ``str.upper`` of the two characters is equal."""
    if (not len(a) or a.max() < 128) and (not len(b) or b.max() < 128):
        return _UPPER[a], _UPPER[b]
    u, inv = np.unique(np.concatenate((a, b)), return_inverse=True)
    ids: dict = {}
    keys = np.array([ids.setdefault(chr(c).upper(), len(ids)) for c in u])
    keys = keys[inv.reshape(-1)]
    return keys[: len(a)], keys[len(a) :]


def validate_cigar(cigar: str, edit_distance: int, reference: str, read: str,
                   start_in_reference: int = 0) -> None:
    """Semantic CIGAR oracle (validateCigarString, tests.cu:106-169);
    raises CigarError on any violation, in the JAX oracle's order and with
    its messages: the runs are well formed, the read is covered exactly,
    the reference stays in bounds, '='/'X' runs agree with the sequences
    (case-insensitive; the first disagreeing base is reported), and the
    edits counted ('M' bases that differ count) equal the reported edit
    distance. Every aligned base is checked at once on arrays; a negative
    start indexes the reference from its end, as Python's indexing does."""
    counts, ops = _run_arrays(cigar)
    on_ref = np.where(ops == _I, 0, counts)
    on_read = np.where(ops == _D, 0, counts)
    start = start_in_reference
    i, j = start + int(on_ref.sum()), int(on_read.sum())
    if j < len(read):
        raise CigarError("CIGAR didn't cover entire read")
    if j > len(read):
        raise CigarError("CIGAR went out of bounds of read")
    if i > len(reference):
        raise CigarError("CIGAR went out of bounds of reference")

    # every aligned base: its op, reference index i and read index j
    diag = (ops != _I) & (ops != _D)
    n = counts[diag]
    k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    op = np.repeat(ops[diag], n)
    ri = np.repeat((np.cumsum(on_ref) - on_ref)[diag], n) + k
    qi = np.repeat((np.cumsum(on_read) - on_read)[diag], n) + k
    if start >= 0:
        ref, at = _codes(reference[start:i]), ri
        ri = ri + start
    else:
        ri = ri + max(start, -2**62)
        ref, at = _codes(reference), ri + len(reference) * (ri < 0)
    bad_index = at < 0
    rb = ref[np.where(bad_index, 0, at)] if len(ref) else at * 0
    qb = _codes(read)[qi]
    fr, fq = _folded(rb, qb)
    same = fr == fq
    bad = bad_index | (same & (op == _X)) | (~same & (op == _EQ))
    if bad.any():
        f = int(bad.argmax())
        if bad_index[f]:
            raise IndexError("string index out of range")
        where = f"reference[{int(ri[f])}] and read[{int(qi[f])}]"
        if op[f] == _X:
            raise CigarError(f"CIGAR contains 'X' but {where} match")
        raise CigarError(f"CIGAR contains '=' but {where} mismatch")
    edits = (int(counts[(ops == _I) | (ops == _D) | (ops == _X)].sum())
             + int(((op == _M) & (rb != qb)).sum()))
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


def affine_score(cigar: str, match: int = 2, mismatch: int = 4,
                 gap_open: int = 4, gap_extend: int = 2) -> int:
    """Affine-gap score of an extended CIGAR (get_alignment_score,
    cpu_baseline.cpp:694-725, default scoring 2, 4, 4, 2): +match a
    matched base, -mismatch a mismatched one, -(gap_open + gap_extend *
    len) a gap run; 'M' counts as matches."""
    score = 0
    for count, op in parse_cigar(cigar):
        if op == "X":
            score -= mismatch * count
        elif op in ("I", "D"):
            score -= gap_open + gap_extend * count
        else:
            score += match * count
    return score


def edits_in_cigar(cigar: str) -> int:
    """Total I+D+X count (extended CIGAR, no ambiguous 'M')."""
    return sum(c for c, op in parse_cigar(cigar) if op in "IDX")


def aligned_pairs(cigar: str,
                  start_in_reference: int = 0) -> Iterator[Tuple[int, int]]:
    """Yield (ref_pos, read_pos) for every aligned (=/X/M) base."""
    i, j = start_in_reference, 0
    for count, op in parse_cigar(cigar):
        if op == "I":
            j += count
        elif op == "D":
            i += count
        else:
            for _ in range(count):
                yield (i, j)
                i += 1
                j += 1
