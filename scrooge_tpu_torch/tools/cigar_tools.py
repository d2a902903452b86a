"""CIGAR inspection and accuracy analysis.

The port's own copy of ``scrooge_tpu/tools/cigar_tools.py``.

Analogue of scripts/cigar_inspector.py (per-pair alignment-path plots from
accuracy CSVs, sorted worst-score-first) and scripts/analyze_cigar.py
(CIGAR vs MAF ground-truth match-coordinate comparison -> fraction of
correctly aligned bases, the metric behind plot.py:2724-2952).

CLI:
  python -m scrooge_tpu_torch.tools.cigar_tools inspect --csv=acc_cigar.csv \
      [--count=9] [--out=paths.png]
  python -m scrooge_tpu_torch.tools.cigar_tools analyze --csv=acc_cigar.csv \
      --maf=candidates.maf
"""

from __future__ import annotations

import argparse
import csv
import sys
from typing import List, Set, Tuple

from ..cigar import parse_cigar


def cigar_path(cigar: str) -> List[Tuple[int, int]]:
    """(text_pos, read_pos) vertices of the alignment path."""
    i = j = 0
    pts = [(0, 0)]
    for count, op in parse_cigar(cigar):
        if op == "I":
            j += count
        elif op == "D":
            i += count
        else:
            i += count
            j += count
        pts.append((i, j))
    return pts


def cigar_match_coords(cigar: str) -> Set[Tuple[int, int]]:
    """(text_pos, read_pos) of every '=' base (analyze_cigar.py:38-67
    semantics: matches only)."""
    out: Set[Tuple[int, int]] = set()
    i = j = 0
    for count, op in parse_cigar(cigar):
        if op == "=":
            out.update((i + k, j + k) for k in range(count))
        if op in "=XM":
            i += count
            j += count
        elif op == "I":
            j += count
        else:
            i += count
    return out


def maf_match_coords(ref_row: str, read_row: str) -> Set[Tuple[int, int]]:
    """Ground-truth match coordinates from a MAF block's two aligned rows
    (gapped with '-'; analyze_cigar.py:22-36 semantics)."""
    out: Set[Tuple[int, int]] = set()
    i = j = 0
    for a, b in zip(ref_row, read_row):
        if a == "-":
            j += 1
        elif b == "-":
            i += 1
        else:
            if a.upper() == b.upper():
                out.add((i, j))
            i += 1
            j += 1
    return out


def correctly_aligned_fraction(cigar: str,
                               ref_row: str, read_row: str) -> float:
    """Fraction of ground-truth matched bases the CIGAR aligns identically
    (the plot.py accuracy-vs-groundtruth metric)."""
    truth = maf_match_coords(ref_row, read_row)
    if not truth:
        return 1.0
    got = cigar_match_coords(cigar)
    return len(truth & got) / len(truth)


def _read_accuracy_csv(path: str):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    if rows and "cigar" not in rows[0]:
        raise SystemExit("CSV has no 'cigar' column; regenerate the "
                         "accuracy sweep with --cigar")
    return rows


def inspect(csv_path: str, count: int, out: str):
    """Plot the alignment paths of the `count` worst-scoring pairs
    (cigar_inspector.py behavior)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _read_accuracy_csv(csv_path)
    rows.sort(key=lambda r: int(r["score"]))
    rows = rows[:count]
    cols = int(count ** 0.5 + 0.999)
    rws = -(-count // cols)
    fig, axes = plt.subplots(rws, cols, figsize=(3 * cols, 3 * rws),
                             squeeze=False)
    for ax, row in zip(axes.flat, rows):
        pts = cigar_path(row["cigar"])
        ax.plot([p[0] for p in pts], [p[1] for p in pts], lw=1)
        ax.set_title(f'pair {row["pair_idx"]} score {row["score"]}',
                     fontsize=8)
        ax.set_xlabel("reference", fontsize=7)
        ax.set_ylabel("read", fontsize=7)
    for ax in axes.flat[len(rows):]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


def maf_truth_rows(maf_path: str) -> List[Tuple[str, str]]:
    """The gapped (ref_row, read_row) pairs of each MAF block, in order
    (read description order matches candidate order, which matches pair
    order after the join)."""
    blocks = []
    with open(maf_path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        if lines[i].startswith("a"):
            rows = {}
            i += 1
            while i < len(lines) and lines[i].strip():
                if lines[i].startswith("s"):
                    fields = lines[i].split()
                    rows[fields[1]] = fields[6]
                i += 1
            if "ref" in rows and len(rows) >= 2:
                read_row = next(v for k, v in rows.items() if k != "ref")
                blocks.append((rows["ref"], read_row))
        else:
            i += 1
    return blocks


def analyze(csv_path: str, maf_path: str):
    """Print per-pair and mean correctly-aligned-base fractions against
    MAF ground truth."""
    blocks = maf_truth_rows(maf_path)
    rows = _read_accuracy_csv(csv_path)
    fractions = []
    for r in rows:
        idx = int(r["pair_idx"])
        if idx >= len(blocks):
            continue
        ref_row, read_row = blocks[idx]
        frac = correctly_aligned_fraction(r["cigar"], ref_row, read_row)
        fractions.append(frac)
        print(f"pair_idx={idx} correctly_aligned={frac:.4f}")
    if fractions:
        print(f"mean_correctly_aligned={sum(fractions)/len(fractions):.4f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["inspect", "analyze"])
    p.add_argument("--csv", required=True)
    p.add_argument("--maf")
    p.add_argument("--count", type=int, default=9)
    p.add_argument("--out", default="cigar_paths.png")
    args = p.parse_args(argv)
    if args.mode == "inspect":
        inspect(args.csv, args.count, args.out)
    else:
        if not args.maf:
            p.error("--maf required for analyze")
        analyze(args.csv, args.maf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
