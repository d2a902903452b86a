"""What decides ``correct``: the timed calls' answers against the reference.

From each read set a sample of pairs is drawn from the seed, the pair of
the set's longest read always among them. Every timed call's answer
(edit distance and CIGAR) for each sampled pair of its set is kept, and
once the window has closed the plain reference (``reference.py``) aligns
each sampled pair once from the benchmark's own inputs: the read, and the
genome from the candidate position on. A kept answer that differs from the
reference's, or is missing, is a mismatch; so is each pair of a timed call
that has no answer at all (``missing``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from scrooge_tpu_torch import PackedAlignments

from portbench import reference
from portbench.generate import ReadSet

Answer = Optional[Tuple[int, str]]


def sample(rs: ReadSet, k: int, rng: np.random.Generator) -> np.ndarray:
    """Up to ``k`` pair indices of ``rs``, sorted, the longest read's first
    pair among them."""
    n = len(rs.pairs)
    lens = np.array([len(r.content) for r in rs.reads])
    longest = int(np.flatnonzero(rs.pairs[:, 0] == int(np.argmax(lens)))[0])
    rest = np.delete(np.arange(n), longest)
    pick = rng.choice(rest, size=min(k, n) - 1, replace=False)
    return np.sort(np.concatenate([[longest], pick]).astype(np.int64))


def _answer(out, i: int) -> Answer:
    if isinstance(out, PackedAlignments):
        return int(out.edit_distances[i]), out.cigar(i)
    a = out[i]
    return None if a is None else (int(a.edit_distance), str(a.cigar))


def answers(out, idx: Sequence[int]) -> List[Answer]:
    """The answers of ``out`` (a list of Alignments, or PackedAlignments)
    at pair indices ``idx``; None where there is none."""
    got: List[Answer] = []
    for i in idx:
        try:
            got.append(_answer(out, int(i)))
        except (IndexError, TypeError, AttributeError):
            got.append(None)
    return got


def missing(out, n: int) -> int:
    """Pairs of ``n`` with no answer in ``out``."""
    if isinstance(out, PackedAlignments):
        return max(n - len(out), 0)
    return max(n - len(out), 0) + sum(a is None for a in out[:n])


def align_reference(genome_content: str, rs: ReadSet, idx: Sequence[int],
                    W: int, K: int, O: int, early_termination: bool = True,
                    priority=reference.PRIORITY) -> reference.Result:
    """The reference's alignment of the pairs ``idx`` of ``rs``."""
    texts, reads = [], []
    for i in idx:
        r, start = rs.pairs[int(i)]
        read = rs.reads[int(r)].content
        span = reference.max_windows(W, O, len(read)) * (W - O) + W
        texts.append(reference.encode(genome_content[start : start + span]))
        reads.append(reference.encode(read))
    return reference.align(texts, reads, W, K, O, early_termination,
                           priority)


def mismatches(kept: List[List[Answer]], ref: reference.Result) -> int:
    """Kept answers (one list a call, in the order of the sample) that
    differ from the reference's, or are missing."""
    want = [None if e < 0 else (int(e), c)
            for e, c in zip(ref.eds.tolist(), ref.cigars)]
    return sum(got != w or got is None
               for call in kept for got, w in zip(call, want))
