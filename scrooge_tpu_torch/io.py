"""File I/O: FASTA/FASTQ/MAF/PAF parsing and seed-location joining.

The port's own copy of ``scrooge_tpu/io.py``: Python equivalents of the
reference's util.cpp with the same observable semantics (same fields
populated, same coordinate transforms, same join):

 - read_fasta / read_genome: util.cpp:45-108 (multi-chromosome
   concatenation with a description -> global-offset map); soft-masked
   (lowercase) content is kept as it is, CRLF line ends are dropped.
 - read_fastq: util.cpp:110-157. Descriptions drop spaces and CRs (the
   seed join matches on this stripped form). Unlike the reference's
   scan-for-'@', which can lose sync on a quality line that begins with
   '@', this parser consumes whole 4-line records.
 - read_maf: util.cpp:178-234. MAF 'a' blocks; the 's ref' line gives the
   chromosome-local start, the other 's' line the read description,
   strand, and aligned-region offset and size.
 - read_paf: util.cpp:236-276.
 - left_extend_locations: util.cpp:284-290 (shift a candidate's start left
   so the alignment can start at read position 0).
 - get_global_seeds: util.cpp:292-301 (chromosome -> global coordinates;
   a genome of one chromosome uses the chromosome-local start directly).
 - read_fastq_and_seed_locations: util.cpp:303-336 (join by description;
   an unknown read description raises ValueError where the reference
   calls exit(1)).

The JAX package's opt-in native FASTA/FASTQ parsers have no copy here: on
the bench's files they were not faster than these (PERF.md).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence as Seq

from .datamodel import CandidateLocation, Genome, Read, Sequence


def read_fasta(path: str | os.PathLike) -> List[Sequence]:
    sequences: List[Sequence] = []
    desc: Optional[str] = None
    parts: List[str] = []
    with open(path, "r") as f:
        for line in f:
            line = line.rstrip("\r\n")
            if line.startswith(">"):
                if desc is not None:
                    sequences.append(Sequence(desc, "".join(parts)))
                desc = line[1:]
                parts = []
            elif desc is not None:
                parts.append(line.replace(" ", ""))
    if desc is not None:
        sequences.append(Sequence(desc, "".join(parts)))
    return sequences


def read_genome(path: str | os.PathLike) -> Genome:
    genome = Genome()
    offset = 0
    content: List[str] = []
    for chrom in read_fasta(path):
        genome.chromosome_starts[chrom.description] = offset
        content.append(chrom.content)
        offset += len(chrom.content)
    genome.content = "".join(content)
    return genome


def read_fastq(path: str | os.PathLike) -> List[Read]:
    reads: List[Read] = []
    with open(path, "r") as f:
        while True:
            header = f.readline()
            if not header:
                break
            header = header.strip()
            if not header.startswith("@"):
                continue
            content = f.readline().strip()
            plus = f.readline()
            if plus.startswith("+"):
                f.readline()  # quality line
            desc = header[1:].replace(" ", "").replace("\r", "")
            reads.append(Read(description=desc, content=content))
    return reads


def read_maf(path: str | os.PathLike) -> List[CandidateLocation]:
    locations: List[CandidateLocation] = []
    with open(path, "r") as f:
        lines = f.read().splitlines()
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        i += 1
        if not line or line[0] != "a":
            continue
        loc = CandidateLocation()
        while i < n:
            line = lines[i]
            i += 1
            if not line.strip():
                break
            if line[0] != "s":
                continue
            fields = line[1:].split()
            src, start, size, strand = (fields[0], int(fields[1]),
                                        int(fields[2]), fields[3])
            if src == "ref":
                loc.start_in_chromosome = start
                loc.chromosome = "ref"
            else:
                loc.read_description = src
                loc.strand = strand == "+"
                loc.start_of_aligned_region = start
                loc.size_of_aligned_region = size
        locations.append(loc)
    return locations


def read_paf(path: str | os.PathLike) -> List[CandidateLocation]:
    locations: List[CandidateLocation] = []
    with open(path, "r") as f:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            fields = line.split("\t")
            loc = CandidateLocation(
                read_description=fields[0],
                chromosome=fields[5],
                start_in_chromosome=int(fields[7]),
                strand=fields[4] == "+",
                start_of_aligned_region=int(fields[2]),
                size_of_aligned_region=int(fields[3]) - int(fields[2]),
            )
            locations.append(loc)
    return locations


def left_extend_locations(locations: Seq[CandidateLocation]) -> None:
    for loc in locations:
        loc.start_in_chromosome = max(
            0, loc.start_in_chromosome - loc.start_of_aligned_region)
        loc.size_of_aligned_region += loc.start_of_aligned_region
        loc.start_of_aligned_region = 0


def get_global_seeds(genome: Genome,
                     locations: Seq[CandidateLocation]) -> None:
    multi = len(genome.chromosome_starts) > 1
    for loc in locations:
        if multi:
            loc.start_in_reference = (
                genome.chromosome_starts.get(loc.chromosome, 0)
                + loc.start_in_chromosome)
        else:
            loc.start_in_reference = loc.start_in_chromosome


def read_fastq_and_seed_locations(
    genome: Genome,
    fastq_path: str | os.PathLike,
    seed_path: str | os.PathLike,
) -> List[Read]:
    seed_path_s = str(seed_path)
    if seed_path_s.endswith(".paf"):
        locations = read_paf(seed_path)
    elif seed_path_s.endswith(".maf"):
        locations = read_maf(seed_path)
    else:
        raise ValueError(f"unknown seed file ending: {seed_path_s}")
    left_extend_locations(locations)
    get_global_seeds(genome, locations)

    reads = read_fastq(fastq_path)
    desc_to_idx: Dict[str, int] = {
        r.description: i for i, r in enumerate(reads)}
    for loc in locations:
        idx = desc_to_idx.get(loc.read_description)
        if idx is None:
            raise ValueError(
                f'candidate location specified unknown read '
                f'"{loc.read_description}"')
        reads[idx].locations.append(loc)
    return reads


def load_dataset(dataset_dir: str | os.PathLike):
    """Load the reference's dataset layout contract
    (profile.py:650,675-695): ``<dir>/{reference.fasta, reads.fastq,
    candidates.maf|paf}`` -> (Genome, reads-with-locations)."""
    ref = os.path.join(dataset_dir, "reference.fasta")
    fastq = os.path.join(dataset_dir, "reads.fastq")
    genome = read_genome(ref)
    for ext in ("maf", "paf"):
        seeds = os.path.join(dataset_dir, f"candidates.{ext}")
        if os.path.exists(seeds):
            return genome, read_fastq_and_seed_locations(genome, fastq, seeds)
    raise FileNotFoundError(f"no candidates.maf/.paf in {dataset_dir}")
