"""Sequence-format converter (scripts/GenConverter.py analogue).

The port's own copy of ``scrooge_tpu/tools/convert.py``.

Converts between FASTA / FASTQ / HGA / VGSIM read formats, with the same
sanitizer semantics as the reference:
 - ``--restrict ACGT`` drops reads containing non-ACGT characters when
   converting reads, and SPLITS genome sequences at non-ACGT runs when
   ``--genome`` is set (GenConverter.py --restrict behavior).
 - ``--prune_titles`` truncates descriptions at the first whitespace.

CLI:
  python -m scrooge_tpu_torch.tools.convert --input=in.fa --output=out.fastq \
      --source_format=FASTA --target_format=FASTQ [--restrict=ACGT]
      [--prune_titles] [--genome]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

Reads = List[Tuple[str, str]]


def import_reads(text: str, source_format: str) -> Reads:
    if source_format in ("FASTA", "HGA"):
        out: Reads = []
        for section in text.split("\n>"):
            if not section.strip():
                continue
            lines = section.split("\n")
            title = lines[0].lstrip(">")
            out.append((title, "".join(lines[1:])))
        return out
    if source_format == "FASTQ":
        lines = [l for l in text.split("\n")]
        if lines and lines[-1] == "":
            lines.pop()
        out = []
        for i in range(0, len(lines), 4):
            out.append((lines[i][1:], lines[i + 1]))
        return out
    if source_format == "VGSIM":
        return [(f"read_{i:06d}", line)
                for i, line in enumerate(text.split("\n")) if line]
    raise ValueError(f"invalid source_format {source_format!r}")


def export_reads(reads: Reads, target_format: str) -> str:
    if target_format == "FASTA":
        return "".join(f">{t}\n{b}\n" for t, b in reads)
    if target_format == "FASTQ":
        return "".join(f"@{t}\n{b}\n+\n{'I' * len(b)}\n" for t, b in reads)
    raise ValueError(f"invalid target_format {target_format!r}")


def restrict_reads(reads: Reads, alphabet: str) -> Reads:
    """Drop reads with characters outside `alphabet`."""
    allowed = set(alphabet)
    return [(t, b) for t, b in reads if set(b) <= allowed]


def restrict_genome(reads: Reads, alphabet: str) -> Reads:
    """Split genome sequences at non-alphabet runs into _partN pieces."""
    allowed = set(alphabet)
    out: Reads = []
    for title, bases in reads:
        part: List[str] = []
        n = 0
        for c in bases:
            if c in allowed:
                part.append(c)
            elif part:
                out.append((f"{title}_part{n}", "".join(part)))
                part = []
                n += 1
        if part:
            out.append((f"{title}_part{n}" if n else title, "".join(part)))
    return out


def prune_titles(reads: Reads) -> Reads:
    return [(t.split()[0] if t.split() else t, b) for t, b in reads]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--source_format", required=True,
                   choices=["FASTA", "FASTQ", "HGA", "VGSIM"])
    p.add_argument("--target_format", required=True,
                   choices=["FASTA", "FASTQ"])
    p.add_argument("--restrict", default=None,
                   help="drop reads / split genomes on other characters")
    p.add_argument("--prune_titles", action="store_true")
    p.add_argument("--genome", action="store_true",
                   help="treat input as genome: split instead of drop")
    args = p.parse_args(argv)

    with open(args.input) as f:
        reads = import_reads(f.read(), args.source_format)
    if args.prune_titles:
        reads = prune_titles(reads)
    if args.restrict:
        reads = (restrict_genome if args.genome else restrict_reads)(
            reads, args.restrict)
    with open(args.output, "w") as f:
        f.write(export_reads(reads, args.target_format))
    print(f"wrote {len(reads)} sequences to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
