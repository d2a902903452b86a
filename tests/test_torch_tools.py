"""The port's format converter and CIGAR accuracy tools against the JAX
package's, on the real-format fixtures, a ``write_dataset`` directory with
ground-truth rows and CIGARs of seeded pairs. Every comparison is exact.
"""

import csv
import os

import numpy as np
import pytest

from scrooge_tpu.tools import cigar_tools as jct
from scrooge_tpu.tools import convert as jconv
from scrooge_tpu_torch.baselines import exact_semiglobal
from scrooge_tpu_torch.tools import cigar_tools as pct
from scrooge_tpu_torch.tools import convert as pconv
from scrooge_tpu_torch.utils import simulate as psim

DATA = os.path.join(os.path.dirname(__file__), "data", "real_format")
INPUTS = [("raw_reference.fasta", "FASTA"),
          ("ont_maf/reference.fasta", "FASTA"),
          ("ilmn_paf/reference.fasta", "HGA"),
          ("ont_maf/reads.fastq", "FASTQ"),
          ("ilmn_paf/reads.fastq", "FASTQ")]


def _read(rel):
    with open(os.path.join(DATA, rel)) as f:
        return f.read()


@pytest.mark.parametrize("rel,fmt", INPUTS)
def test_convert_functions_match_jax(rel, fmt):
    text = _read(rel)
    reads = pconv.import_reads(text, fmt)
    assert reads == jconv.import_reads(text, fmt) and reads
    for target in ("FASTA", "FASTQ"):
        assert pconv.export_reads(reads, target) == \
            jconv.export_reads(reads, target)
    assert pconv.prune_titles(reads) == jconv.prune_titles(reads)
    for alphabet in ("ACGT", "ACGTacgt"):
        assert pconv.restrict_reads(reads, alphabet) == \
            jconv.restrict_reads(reads, alphabet)
        assert pconv.restrict_genome(reads, alphabet) == \
            jconv.restrict_genome(reads, alphabet)


def test_convert_vgsim_and_bad_formats():
    rng = np.random.default_rng(3)
    lines = ["".join("ACGT"[c] for c in rng.integers(0, 4, 30))
             for _ in range(5)]
    text = "\n".join(lines) + "\n"
    assert pconv.import_reads(text, "VGSIM") == \
        jconv.import_reads(text, "VGSIM")
    with pytest.raises(ValueError):
        pconv.import_reads(text, "BAM")
    with pytest.raises(ValueError):
        pconv.export_reads([("a", "ACGT")], "BAM")


@pytest.mark.parametrize("flags", [
    ["--source_format=FASTA", "--target_format=FASTA", "--restrict=ACGT",
     "--genome", "--prune_titles"],
    ["--source_format=FASTA", "--target_format=FASTQ", "--restrict=ACGT"],
    ["--source_format=FASTA", "--target_format=FASTQ"]])
def test_convert_cli_output_matches_jax(tmp_path, flags, capsys):
    src = os.path.join(DATA, "raw_reference.fasta")
    assert pconv.main([f"--input={src}", f"--output={tmp_path}/p",
                       *flags]) == 0
    assert jconv.main([f"--input={src}", f"--output={tmp_path}/j",
                       *flags]) == 0
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(f"{tmp_path}/p", "") == \
        out[1].replace(f"{tmp_path}/j", "")


@pytest.fixture(scope="module")
def truth_dataset(tmp_path_factory):
    """A written dataset with ground-truth rows, and an accuracy CSV of the
    exact baseline's CIGARs on its pairs."""
    out = tmp_path_factory.mktemp("truth")
    ds = psim.simulate_dataset(genome_len=20_000, num_reads=12, read_len=250,
                               seed=21, with_truth=True)
    psim.write_dataset(ds, out)
    rows = []
    for i, r in enumerate(ds.reads):
        s = r.locations[0].start_in_reference
        ed, cigar = exact_semiglobal(ds.genome.content[s : s + 400],
                                     r.content)
        rows.append({"pair_idx": i, "score": -ed, "cigar": cigar})
    with open(out / "acc.csv", "w", newline="") as f:
        w = csv.DictWriter(f, ["pair_idx", "score", "cigar"])
        w.writeheader()
        w.writerows(rows)
    return ds, out, [r["cigar"] for r in rows]


def test_maf_truth_rows_match_jax(truth_dataset):
    ds, out, _ = truth_dataset
    maf = str(out / "candidates.maf")
    assert pct.maf_truth_rows(maf) == jct.maf_truth_rows(maf) == ds.truth


@pytest.mark.parametrize("fn", ["cigar_path", "cigar_match_coords",
                                "maf_match_coords",
                                "correctly_aligned_fraction"])
def test_cigar_tools_match_jax(truth_dataset, fn):
    ds, _, cigars = truth_dataset
    for cigar, (ref_row, read_row) in zip(cigars, ds.truth):
        if fn == "maf_match_coords":
            args = (ref_row, read_row)
        elif fn == "correctly_aligned_fraction":
            args = (cigar, ref_row, read_row)
        else:
            args = (cigar,)
        got = getattr(pct, fn)(*args)
        assert got == getattr(jct, fn)(*args)
    assert pct.correctly_aligned_fraction("", "--", "AC") == 1.0


def test_analyze_output_matches_jax(truth_dataset, capsys):
    _, out, _ = truth_dataset
    pct.analyze(str(out / "acc.csv"), str(out / "candidates.maf"))
    got = capsys.readouterr().out
    jct.analyze(str(out / "acc.csv"), str(out / "candidates.maf"))
    assert got == capsys.readouterr().out
    assert got.count("pair_idx=") == 12
    assert "mean_correctly_aligned=" in got
    assert pct.main(["analyze", f"--csv={out}/acc.csv",
                     f"--maf={out}/candidates.maf"]) == 0
    assert capsys.readouterr().out == got


def test_inspect_plots_the_worst_pairs(truth_dataset, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    _, out, _ = truth_dataset
    png = tmp_path / "paths.png"
    pct.inspect(str(out / "acc.csv"), 4, str(png))
    assert png.stat().st_size > 0
    assert capsys.readouterr().out == f"wrote {png}\n"
