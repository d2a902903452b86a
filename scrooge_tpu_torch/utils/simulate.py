"""Synthetic long-read workload generator (PBSIM2-style).

The port's own copy of ``scrooge_tpu/utils/simulate.py``: the same seed
gives the same genome, reads, truth rows and decoys, draw for draw, and
``write_dataset`` writes the same bytes. Reads are windows of a random
genome with substitutions, insertions and deletions at ``1 - accuracy``
per base in PBSIM2's CLR ratio sub:ins:del = 6:55:39 (the role of the
reference's PBSIM2 container, DATASETS.md:19-29). ``edge_pairs`` and
``multiword_edge_batch`` are the port's own seeded batches for the window
engine's edge cases.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..datamodel import CandidateLocation, Genome, Read

_BASES = np.frombuffer(b"ACGT", np.uint8)


def random_genome(length: int, seed: int = 0, name: str = "chr1") -> Genome:
    rng = np.random.default_rng(seed)
    content = rng.integers(0, 4, length)
    return Genome(
        content=_BASES[content].tobytes().decode("ascii"),
        chromosome_starts={name: 0},
    )


def random_multichrom_genome(length: int, n_chroms: int = 24,
                             seed: int = 0) -> Genome:
    """Multi-chromosome random genome of ``length`` total bases.

    Chromosome sizes decrease human-like (size_i proportional to
    1/(i+2), chr1 largest), concatenated into one content string with a
    chromosome_starts map — the Genome_t shape the reference's FASTA
    parser produces for real references (util.cpp:45-108)."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / (np.arange(n_chroms) + 2.0)
    sizes = np.maximum((weights / weights.sum() * length).astype(np.int64),
                       1)
    sizes[0] += length - int(sizes.sum())  # exact total
    starts = {}
    off = 0
    for i, sz in enumerate(sizes):
        starts[f"chr{i + 1}"] = off
        off += int(sz)
    # chunked build: a single int64 index array for a human-scale genome
    # would peak ~8 bytes/base of temporaries (~25 GB at 3.1 Gbase);
    # uint8 codes in 64 Mbase chunks keep the peak near the output size
    lut = np.frombuffer(b"ACGT", np.uint8)
    parts = []
    CHUNK = 64 * 1024 * 1024
    for s in range(0, length, CHUNK):
        n = min(CHUNK, length - s)
        parts.append(lut[rng.integers(0, 4, n, dtype=np.uint8)].tobytes())
    content = b"".join(parts).decode("ascii")
    return Genome(content=content, chromosome_starts=starts)


GAP = 255  # gap marker in gapped truth rows


def _mutate(rng: np.random.Generator, codes: np.ndarray, error_rate: float,
            ratio=(6, 55, 39), with_truth: bool = False):
    """Apply sub/ins/del edits at `error_rate` per base (ratio sums to 100).

    Vectorized: substitutions rotate the code, insertions keep the base and
    append a random one, deletions drop it.

    With ``with_truth``, also returns the true gapped alignment rows
    (ref_row, read_row) as uint8 code arrays with GAP for '-' — the
    PBSIM2-MAF ground truth the reference's accuracy evaluation compares
    CIGARs against (plot.py:2724-2952, analyze_cigar.py:22-36). The RNG
    draw sequence is identical with or without truth, so datasets
    generated by earlier versions reproduce bit-for-bit."""
    n = len(codes)
    p_sub = error_rate * ratio[0] / sum(ratio)
    p_ins = error_rate * ratio[1] / sum(ratio)
    p_del = error_rate * ratio[2] / sum(ratio)
    u = rng.random(n)
    kind = np.select(
        [u < p_sub, u < p_sub + p_ins, u < p_sub + p_ins + p_del],
        [1, 2, 3], default=0)
    orig = codes
    codes = np.where(kind == 1,
                     (codes + rng.integers(1, 4, n)) % 4,
                     codes).astype(np.uint8)
    reps = np.where(kind == 3, 0, np.where(kind == 2, 2, 1))
    out = np.repeat(codes, reps)
    # the second copy of each insertion becomes a random base
    ins_ends = np.cumsum(reps)[kind == 2] - 1
    ins_vals = None
    if len(ins_ends):
        ins_vals = rng.integers(0, 4, len(ins_ends))
        out[ins_ends] = ins_vals
    if not len(out):
        out = rng.integers(0, 4, 1).astype(np.uint8)
    out = out.astype(np.uint8)
    if not with_truth:
        return out
    # gapped rows: both sides repeat 2x at insertions (ref gains a gap),
    # 1x elsewhere (deletions put the gap on the read side)
    areps = np.where(kind == 2, 2, 1)
    a_ends = np.cumsum(areps) - 1
    ref_row = np.repeat(orig, areps)
    read_row = np.repeat(codes, areps)
    if len(ins_ends):
        ref_row[a_ends[kind == 2]] = GAP
        read_row[a_ends[kind == 2]] = ins_vals
    read_row[a_ends[kind == 3]] = GAP
    return out, ref_row, read_row


@dataclass
class SimulatedDataset:
    genome: Genome
    reads: List[Read]
    # per read: (ref_row, read_row) gapped truth strings ('-' for gaps),
    # present when simulated with_truth (the PBSIM2 MAF ground-truth rows)
    truth: "List[Tuple[str, str]] | None" = None


def _row_str(row: np.ndarray) -> str:
    chars = np.where(row == GAP, ord("-"), _BASES[np.minimum(row, 3)])
    return chars.astype(np.uint8).tobytes().decode("ascii")


def simulate_reads(
    genome: Genome,
    num_reads: int,
    read_len: int,
    accuracy: float = 0.95,
    seed: int = 0,
    with_truth: bool = False,
    decoys: float = 0.0,
):
    """Sample reads with candidate locations at the true sampling position
    (the 'groundtruth' candidate model, DATASETS.md:45-75).

    ``decoys`` > 0 switches to the 'chained' candidate model (the
    pbsim_chained family: minimap2 -P keeps secondary chains, so reads
    carry extra, mostly-wrong candidates): each read gains
    Poisson(decoys) additional candidates at random genome positions,
    appended after the true one. Decoy draws come from a SEPARATE RNG so
    read content is bit-identical to the groundtruth model at the same
    seed.

    With ``with_truth``, returns (reads, truth) where truth[i] is the
    read's true gapped alignment (ref_row, read_row) — same RNG stream
    either way."""
    import bisect

    rng = np.random.default_rng(seed)
    drng = np.random.default_rng(seed ^ 0x5EED) if decoys > 0 else None
    gcodes = np.frombuffer(genome.content.encode("ascii"), np.uint8)
    lut = np.full(256, 0, np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    gcodes = lut[gcodes]
    glen = len(gcodes)
    # chromosome attribution by global offset (multi-chromosome genomes:
    # chromosome_starts maps name -> global offset, util.cpp:96-108)
    cnames = list(genome.chromosome_starts) or ["chr1"]
    cstarts = [genome.chromosome_starts.get(c, 0) for c in cnames]

    def chrom_of(pos: int):
        i = max(bisect.bisect_right(cstarts, pos) - 1, 0)
        return cnames[i], pos - cstarts[i]

    reads = []
    truth = []
    for r in range(num_reads):
        start = int(rng.integers(0, max(1, glen - read_len)))
        seg = gcodes[start : start + read_len]
        m = _mutate(rng, seg, 1.0 - accuracy, with_truth=with_truth)
        if with_truth:
            mutated, ref_row, read_row = m
            truth.append((_row_str(ref_row), _row_str(read_row)))
        else:
            mutated = m
        desc = f"sim_read_{r}"
        cname, coff = chrom_of(start)
        loc = CandidateLocation(
            read_description=desc,
            chromosome=cname,
            start_in_chromosome=coff,
            start_in_reference=start,
            strand=True,
        )
        locs = [loc]
        if drng is not None:
            for start_d in drng.integers(
                    0, max(1, glen - read_len), drng.poisson(decoys)):
                dname, doff = chrom_of(int(start_d))
                locs.append(CandidateLocation(
                    read_description=desc,
                    chromosome=dname,
                    start_in_chromosome=doff,
                    start_in_reference=int(start_d),
                    strand=True,
                ))
        reads.append(Read(
            description=desc,
            content=_BASES[mutated].tobytes().decode("ascii"),
            locations=locs,
        ))
    return (reads, truth) if with_truth else reads


def simulate_dataset(
    genome_len: int = 1_000_000,
    num_reads: int = 1000,
    read_len: int = 10_000,
    accuracy: float = 0.95,
    seed: int = 0,
    with_truth: bool = False,
    decoys: float = 0.0,
) -> SimulatedDataset:
    genome = random_genome(genome_len, seed=seed, name="ref")
    r = simulate_reads(genome, num_reads, read_len, accuracy, seed=seed + 1,
                       with_truth=with_truth, decoys=decoys)
    if with_truth:
        reads, truth = r
        return SimulatedDataset(genome=genome, reads=reads, truth=truth)
    return SimulatedDataset(genome=genome, reads=r)


def write_dataset(ds: SimulatedDataset, out_dir) -> None:
    """Materialize the reference's dataset directory contract
    (profile.py:650): reference.fasta + reads.fastq + candidates.maf.
    The MAF blocks carry the true gapped rows when the dataset was
    simulated with_truth (the pbsim_groundtruth dataset shape,
    DATASETS.md:45-75), so tools/cigar_tools analyze can score CIGARs
    against them."""
    import os

    os.makedirs(str(out_dir), exist_ok=True)
    j = os.path.join
    with open(j(str(out_dir), "reference.fasta"), "w") as f:
        name = next(iter(ds.genome.chromosome_starts), "ref")
        f.write(f">{name}\n")
        c = ds.genome.content
        for i in range(0, len(c), 80):
            f.write(c[i : i + 80] + "\n")
    with open(j(str(out_dir), "reads.fastq"), "w") as f:
        for read in ds.reads:
            f.write(f"@{read.description}\n{read.content}\n+\n"
                    f"{'~' * len(read.content)}\n")
    with open(j(str(out_dir), "candidates.maf"), "w") as f:
        glen = len(ds.genome.content)
        for i, read in enumerate(ds.reads):
            loc = read.locations[0]
            ref_row, read_row = (ds.truth[i] if ds.truth
                                 else (read.content, read.content))
            ref_size = len(ref_row) - ref_row.count("-")
            f.write("a\n")
            f.write(f"s ref {loc.start_in_chromosome} {ref_size} + "
                    f"{glen} {ref_row}\n")
            f.write(f"s {read.description} 0 {len(read.content)} + "
                    f"{len(read.content)} {read_row}\n\n")


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
