"""Seeded read-mapping inputs: a genome, and PBSIM2-style reads drawn from it.

Adapted from scrooge_tpu_torch/utils/simulate.py at commit 00e5ff3
(``random_multichrom_genome``, ``simulate_reads`` and ``_mutate``): the
same model, drawn otherwise. Reads are windows of the genome with
substitutions, insertions and deletions at ``1 - accuracy`` a base in the
ratio sub:ins:del (PBSIM2's CLR default 6:55:39); a substitution rotates
the base, an insertion keeps it and adds a random one after it, a deletion
drops it. Each read has its true position as a candidate, and with
``decoys`` > 0 Poisson(decoys) further candidates at uniform positions
(the chained candidate model).

Everything is drawn on ``device`` by one ``torch.Generator`` seeded with
the run's seed, in a few large calls in uint8, so a genome of GRCh38's
3.09 Gbp takes seconds and no int64 array of its length is ever made. The
same seed on the same kind of device gives the same inputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from scrooge_tpu_torch import CandidateLocation, Genome, Read

# bases drawn a call: bounds the temporaries of the mutation step
_READ_BASES_PER_DRAW = 1 << 27


@dataclass
class ReadSet:
    """One call's reads, and its (read, candidate) pairs in output order."""

    reads: List[Read]
    pairs: np.ndarray  # (n, 2): (read index, candidate start), in the
                       # order align_reads returns its alignments


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def _ascii(codes: torch.Tensor) -> torch.Tensor:
    """2-bit codes (uint8) -> ASCII ACGT, in place: 0, 1, 2, 3 -> 65, 67,
    71, 84."""
    hi = codes >= 2
    t = codes == 3
    codes.mul_(2).add_(65)
    codes.add_(hi.to(torch.uint8).mul_(2))
    codes.add_(t.to(torch.uint8).mul_(11))
    return codes


def make_genome(lengths: Sequence[int], gen: torch.Generator, device):
    """(Genome with its chromosome map, the genome's 2-bit codes on
    ``device``, uint8)."""
    total = int(sum(lengths))
    codes = torch.randint(0, 4, (total,), generator=gen, device=device,
                          dtype=torch.uint8)
    text = _ascii(codes.clone()).cpu().numpy()
    starts, off = {}, 0
    for i, n in enumerate(lengths):
        starts[f"chr{i + 1}"] = off
        off += int(n)
    genome = Genome(content=str(memoryview(text), "ascii"),
                    chromosome_starts=starts)
    return genome, codes


def _mutate(seg: torch.Tensor, accuracy: float, ratio, gen):
    """Mutated reads of the (R, L) uint8 codes ``seg``: (flat codes of all
    reads, each read's length), both on seg's device."""
    R, L = seg.shape
    err = 1.0 - accuracy
    tot = float(sum(ratio))
    p_sub = err * ratio[0] / tot
    p_ins = p_sub + err * ratio[1] / tot
    p_del = p_ins + err * ratio[2] / tot
    u = torch.rand((R, L), generator=gen, device=seg.device)
    kind = torch.zeros((R, L), dtype=torch.uint8, device=seg.device)
    kind[u < p_del] = 3
    kind[u < p_ins] = 2
    kind[u < p_sub] = 1
    del u
    rot = torch.randint(1, 4, (R, L), generator=gen, device=seg.device,
                        dtype=torch.uint8)
    seg = torch.where(kind == 1, (seg + rot) % 4, seg)
    del rot
    reps = (1 + (kind == 2).to(torch.int64)
            - (kind == 3).to(torch.int64)).reshape(-1)
    out = torch.repeat_interleave(seg.reshape(-1), reps)
    ins_ends = (torch.cumsum(reps, 0) - 1)[kind.reshape(-1) == 2]
    out[ins_ends] = torch.randint(0, 4, (ins_ends.numel(),), generator=gen,
                                  device=seg.device, dtype=torch.uint8)
    return out, reps.reshape(R, L).sum(1)


def make_reads(genome: Genome, gcodes: torch.Tensor, n_reads: int,
               read_len: int, accuracy: float, ratio, decoys: float,
               gen: torch.Generator, prefix: str = "r") -> ReadSet:
    """``n_reads`` reads of ``read_len`` genome bases each before mutation,
    with their candidates (module doc)."""
    dev = gcodes.device
    glen = gcodes.numel()
    span = max(1, glen - read_len)
    starts = torch.randint(0, span, (n_reads,), generator=gen, device=dev)
    per = max(1, _READ_BASES_PER_DRAW // max(read_len, 1))
    flats, lens = [], []
    cols = torch.arange(read_len, device=dev)
    for r0 in range(0, n_reads, per):
        s = starts[r0 : r0 + per]
        seg = gcodes[s[:, None] + cols]
        flat, n = _mutate(seg, accuracy, ratio, gen)
        flats.append(flat)
        lens.append(n)
    lens = torch.cat(lens)
    text = _ascii(torch.cat(flats)).cpu().numpy()
    lens = lens.cpu().numpy()
    starts_h = starts.cpu().numpy()
    n_dec = (torch.poisson(torch.full((n_reads,), float(decoys), device=dev),
                           generator=gen).to(torch.int64)
             if decoys > 0 else torch.zeros(n_reads, dtype=torch.int64,
                                            device=dev))
    dec_starts = torch.randint(0, span, (int(n_dec.sum().item()),),
                               generator=gen, device=dev).cpu().numpy()
    n_dec = n_dec.cpu().numpy()

    # the pairs in output order: each read's true position, then its decoys
    per_read = 1 + n_dec
    first = np.zeros(n_reads, np.int64)
    np.cumsum(per_read[:-1], out=first[1:])
    pos = np.empty(int(per_read.sum()), np.int64)
    is_decoy = np.ones(len(pos), bool)
    is_decoy[first] = False
    pos[first] = starts_h
    pos[is_decoy] = dec_starts
    names = list(genome.chromosome_starts) or ["chr1"]
    cstarts = np.array([genome.chromosome_starts.get(c, 0) for c in names],
                       np.int64)
    chrom = np.searchsorted(cstarts, pos, side="right") - 1
    in_chrom = (pos - cstarts[chrom]).tolist()
    chrom, pos_l = chrom.tolist(), pos.tolist()

    offs = np.zeros(n_reads + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    offs = offs.tolist()
    buf = text.tobytes()
    reads = []
    bounds = np.concatenate([first, [len(pos)]]).tolist()
    for k in range(n_reads):
        desc = f"{prefix}{k}"
        locs = [CandidateLocation(
            read_description=desc, chromosome=names[chrom[q]],
            start_in_chromosome=in_chrom[q], start_in_reference=pos_l[q],
            strand=True) for q in range(bounds[k], bounds[k + 1])]
        reads.append(Read(description=desc,
                          content=buf[offs[k]:offs[k + 1]].decode("ascii"),
                          locations=locs))
    pairs = np.stack([np.repeat(np.arange(n_reads), per_read), pos], 1)
    return ReadSet(reads, pairs)
