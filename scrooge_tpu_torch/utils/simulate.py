"""Synthetic long-read workload generator (PBSIM2-style).

The port's own copy of ``simulate_dataset`` from
``scrooge_tpu/utils/simulate.py``: the same seed gives the same genome and
reads, draw for draw. Reads are windows of a random genome with
substitutions, insertions and deletions at ``1 - accuracy`` per base in
PBSIM2's CLR ratio sub:ins:del = 6:55:39, each with one candidate location
at its true start.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..datamodel import CandidateLocation, Genome, Read

_BASES = np.frombuffer(b"ACGT", np.uint8)


def random_genome(length: int, seed: int = 0, name: str = "chr1") -> Genome:
    rng = np.random.default_rng(seed)
    content = rng.integers(0, 4, length)
    return Genome(content=_BASES[content].tobytes().decode("ascii"),
                  chromosome_starts={name: 0})


def _mutate(rng: np.random.Generator, codes: np.ndarray, error_rate: float,
            ratio=(6, 55, 39)) -> np.ndarray:
    """Sub/ins/del edits at ``error_rate`` per base: substitutions rotate
    the code, insertions keep the base and append a random one, deletions
    drop it."""
    n = len(codes)
    p_sub = error_rate * ratio[0] / sum(ratio)
    p_ins = error_rate * ratio[1] / sum(ratio)
    p_del = error_rate * ratio[2] / sum(ratio)
    u = rng.random(n)
    kind = np.select(
        [u < p_sub, u < p_sub + p_ins, u < p_sub + p_ins + p_del],
        [1, 2, 3], default=0)
    codes = np.where(kind == 1, (codes + rng.integers(1, 4, n)) % 4,
                     codes).astype(np.uint8)
    reps = np.where(kind == 3, 0, np.where(kind == 2, 2, 1))
    out = np.repeat(codes, reps)
    # the second copy of each insertion becomes a random base
    ins_ends = np.cumsum(reps)[kind == 2] - 1
    if len(ins_ends):
        out[ins_ends] = rng.integers(0, 4, len(ins_ends))
    if not len(out):
        out = rng.integers(0, 4, 1).astype(np.uint8)
    return out.astype(np.uint8)


@dataclass
class SimulatedDataset:
    genome: Genome
    reads: List[Read]


def simulate_reads(genome: Genome, num_reads: int, read_len: int,
                   accuracy: float = 0.95, seed: int = 0) -> List[Read]:
    """Reads with one candidate location each, at the true sampling start
    (single-chromosome genomes)."""
    rng = np.random.default_rng(seed)
    lut = np.zeros(256, np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    gcodes = lut[np.frombuffer(genome.content.encode("ascii"), np.uint8)]
    glen = len(gcodes)
    chrom = next(iter(genome.chromosome_starts), "chr1")
    reads = []
    for r in range(num_reads):
        start = int(rng.integers(0, max(1, glen - read_len)))
        mutated = _mutate(rng, gcodes[start : start + read_len], 1.0 - accuracy)
        desc = f"sim_read_{r}"
        loc = CandidateLocation(read_description=desc, chromosome=chrom,
                                start_in_chromosome=start,
                                start_in_reference=start, strand=True)
        reads.append(Read(description=desc,
                          content=_BASES[mutated].tobytes().decode("ascii"),
                          locations=[loc]))
    return reads


def simulate_dataset(genome_len: int = 1_000_000, num_reads: int = 1000,
                     read_len: int = 10_000, accuracy: float = 0.95,
                     seed: int = 0) -> SimulatedDataset:
    genome = random_genome(genome_len, seed=seed, name="ref")
    return SimulatedDataset(genome=genome, reads=simulate_reads(
        genome, num_reads, read_len, accuracy, seed=seed + 1))


def edge_pairs(seed: int, B: int, T: int, P: int, tb_limit: int):
    """A seeded batch of unstructured pairs that reaches the window
    engine's edge cases, as 2-bit codes: ``(text (B, T) uint8, text_len
    (B,) int32, pattern (B, P) uint8, pattern_len (B,) int32)``.

    Lanes cycle through eight kinds: an unrelated text and pattern (window
    distances past 16 rows, FAIL_TB for a small K), a 25 % and a 5 % error
    rate, a text that runs out long before the read (windows with n = 0), a
    read of k * tb_limit + 1 chars copied exactly and one at 25 % errors
    (one-character last windows), an empty read and a 10 % error rate."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, (B, T), dtype=np.uint8)
    pattern = np.zeros((B, P), np.uint8)
    tlen = np.full(B, T, np.int32)
    plen = np.zeros(B, np.int32)
    for b in range(B):
        kind = b % 8
        if kind == 0:
            q = rng.integers(0, 4, int(rng.integers(P // 2, P + 1)))
        elif kind == 3:
            tlen[b] = int(rng.integers(0, 41))
            q = np.concatenate([text[b, : tlen[b]],
                                rng.integers(0, 4, P)]).astype(np.uint8)
        elif kind in (4, 5):
            k = int(rng.integers(1, max(2, min(P, T) // tb_limit)))
            q = text[b, : k * tb_limit + 1]
            if kind == 5:
                q = _mutate(rng, q, 0.25)
        elif kind == 6:
            q = np.zeros(0, np.uint8)
        else:
            rate = {1: 0.25, 2: 0.05, 7: 0.10}[kind]
            q = _mutate(rng, text[b, : int(rng.integers(1, T + 1))], rate)
        q = q[:P]
        pattern[b, : len(q)] = q
        plen[b] = len(q)
    return text, tlen, pattern, plen


def multiword_edge_batch(cfg, B: int = 16):
    """The edge_pairs batch the multiword window tests share: B lanes,
    reads of up to 2 tb_limit + 20 chars (up to 3 windows), texts 40
    chars longer, seeded by the config."""
    P = 2 * cfg.tb_limit + 20
    return edge_pairs(cfg.W + cfg.O + cfg.K, B, P + 40, P, cfg.tb_limit)
