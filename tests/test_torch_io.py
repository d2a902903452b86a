"""The port's file I/O and dataset writer against the JAX package's, field
for field and byte for byte.

Inputs: the in-repo real-format fixtures (tests/data/real_format), the
parser traps of tests/test_io.py, tests/test_native.py and
tests/test_real_fixtures.py, files written by ``write_dataset`` and
strings made from a numpy seed. Every comparison is exact equality.
"""

import dataclasses
import os

import numpy as np
import pytest

from scrooge_tpu import datamodel as jdm
from scrooge_tpu import io as jio
from scrooge_tpu.utils import simulate as jsim
from scrooge_tpu_torch import datamodel as pdm
from scrooge_tpu_torch import io as pio
from scrooge_tpu_torch.tools import cigar_tools as ptools
from scrooge_tpu_torch.utils import simulate as psim

DATA = os.path.join(os.path.dirname(__file__), "data", "real_format")
FIXTURES = ["ont_maf", "ilmn_paf"]


def fields(obj):
    """Plain data of a dataclass, or of a list of them."""
    if isinstance(obj, list):
        return [fields(x) for x in obj]
    return dataclasses.asdict(obj)


@pytest.fixture
def traps(tmp_path):
    """tests/test_io.py's dataset: two chromosomes, a description with a
    space, a quality line that starts with '@'."""
    (tmp_path / "reference.fasta").write_text(
        ">chr1\nACGTACGTAC\nGTACGT\n>chr2\nTTTTCCCC\n")
    (tmp_path / "reads.fastq").write_text(
        "@read1 extra\nACGTAC\n+\nIIIIII\n@read2\nTTTTCC\n+\n@IIIII\n")
    return tmp_path


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("reader", ["read_fasta", "read_genome",
                                    "read_fastq"])
def test_fixture_parsers_match_jax(name, reader):
    path = os.path.join(DATA, name, "reads.fastq" if reader == "read_fastq"
                        else "reference.fasta")
    got = fields(getattr(pio, reader)(path))
    assert got == fields(getattr(jio, reader)(path))
    assert got  # the fixtures are not empty


@pytest.mark.parametrize("name,reader", [("ont_maf", "read_maf"),
                                         ("ilmn_paf", "read_paf")])
def test_fixture_seed_parsers_match_jax(name, reader):
    path = os.path.join(DATA, name, "candidates." + reader[-3:])
    got = getattr(pio, reader)(path)
    assert fields(got) == fields(getattr(jio, reader)(path))
    # both strands are present in both fixtures
    assert {loc.strand for loc in got} == {True, False}


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_load_dataset_matches_jax(name):
    pg, preads = pio.load_dataset(os.path.join(DATA, name))
    jg, jreads = jio.load_dataset(os.path.join(DATA, name))
    assert fields(pg) == fields(jg)
    assert fields(preads) == fields(jreads)
    assert sum(len(r.locations) for r in preads) in (8, 10)


def test_softmask_crlf_and_multichrom_fixtures():
    """Soft-masked content stays lowercase, a CRLF chromosome parses, and
    chr2's candidates land at its global offset (test_real_fixtures)."""
    s = pio.read_fasta(os.path.join(DATA, "ont_maf", "reference.fasta"))[0]
    assert s.content[2000:2400] == s.content[2000:2400].lower()
    seqs = pio.read_fasta(os.path.join(DATA, "ilmn_paf", "reference.fasta"))
    assert [len(x.content) for x in seqs] == [4200, 3000]
    genome, reads = pio.load_dataset(os.path.join(DATA, "ilmn_paf"))
    r2 = [r for r in reads if r.description.startswith("SRR13278681.2")][0]
    assert r2.locations[0].start_in_reference == 4200 + 103
    genome, reads = pio.load_dataset(os.path.join(DATA, "ont_maf"))
    by_desc = {r.description.split("length=")[0]: r for r in reads}
    assert by_desc["S1_1"].locations[0].start_in_reference == 3990 - 13
    assert by_desc["S1_8"].locations[0].strand is False


def test_traps_fasta_fastq(traps):
    for reader in ("read_fasta", "read_genome"):
        assert (fields(getattr(pio, reader)(traps / "reference.fasta"))
                == fields(getattr(jio, reader)(traps / "reference.fasta")))
    got = pio.read_fastq(traps / "reads.fastq")
    assert fields(got) == fields(jio.read_fastq(traps / "reads.fastq"))
    assert [(r.description, r.content) for r in got] == [
        ("read1extra", "ACGTAC"), ("read2", "TTTTCC")]


MAF = """\
##maf version=1
a
s ref 4 6 + 16 ACGTAC
s read1extra 2 4 + 6 GTAC

a
s ref 0 6 + 8 TTTTCC
s read2 0 6 + 6 TTTTCC
"""
PAF = "read1extra\t6\t1\t5\t+\tchr2\t8\t3\t7\t4\t4\t60\n"


@pytest.mark.parametrize("seeds,text", [("candidates.maf", MAF),
                                        ("candidates.paf", PAF)])
def test_traps_seed_join(traps, seeds, text):
    (traps / seeds).write_text(text)
    out = {}
    for mod in (pio, jio):
        genome = mod.read_genome(traps / "reference.fasta")
        out[mod] = mod.read_fastq_and_seed_locations(
            genome, traps / "reads.fastq", traps / seeds)
        assert fields(mod.load_dataset(traps)[1]) == fields(out[mod])
    assert fields(out[pio]) == fields(out[jio])
    loc = out[pio][0].locations[0]
    # left extension; MAF's "ref" is absent from a two-chromosome genome
    # (offset 0), PAF's chr2 starts at 16
    assert (loc.start_in_chromosome, loc.start_of_aligned_region) == (2, 0)
    assert loc.start_in_reference == (2 if seeds.endswith("maf") else 18)


def test_unknown_read_raises(traps):
    (traps / "candidates.paf").write_text(
        "ghost\t6\t0\t6\t+\tchr1\t16\t0\t6\t6\t6\t60\n")
    for mod in (pio, jio):
        genome = mod.read_genome(traps / "reference.fasta")
        with pytest.raises(ValueError, match='unknown read "ghost"'):
            mod.read_fastq_and_seed_locations(
                genome, traps / "reads.fastq", traps / "candidates.paf")
    with pytest.raises(ValueError, match="unknown seed file ending"):
        pio.read_fastq_and_seed_locations(genome, traps / "reads.fastq",
                                          traps / "reads.fastq")


@pytest.mark.parametrize("n_chroms", [1, 3])
def test_global_seeds_and_left_extension(n_chroms):
    """One chromosome: the chromosome-local start is used directly, even
    under another name; several: the chromosome's start + the local one."""
    rng = np.random.default_rng(n_chroms)
    rows = list(zip(rng.integers(0, n_chroms + 1, 12).tolist(),
                    rng.integers(0, 900, 12).tolist(),
                    rng.integers(0, 50, 12).tolist(),
                    rng.integers(1, 100, 12).tolist()))
    starts = {f"c{i}": 1000 * i for i in range(n_chroms)}
    out = []
    for mod, dm in ((pio, pdm), (jio, jdm)):
        locs = [dm.CandidateLocation(read_description=f"r{k}",
                                     chromosome=f"c{c}",
                                     start_in_chromosome=s,
                                     start_of_aligned_region=a,
                                     size_of_aligned_region=z)
                for k, (c, s, a, z) in enumerate(rows)]
        mod.left_extend_locations(locs)
        mod.get_global_seeds(dm.Genome(content="A" * 5000,
                                       chromosome_starts=starts), locs)
        out.append(fields(locs))
    assert out[0] == out[1]
    assert all(loc["start_of_aligned_region"] == 0 for loc in out[0])


def test_multichromosome_files(tmp_path):
    """tests/test_multichrom.py's join: a read on chr2 at local 500 lands
    at global 3500."""
    rng = np.random.default_rng(4)
    bases = np.frombuffer(b"ACGT", np.uint8)
    chr1 = bases[rng.integers(0, 4, 3000)].tobytes().decode()
    chr2 = bases[rng.integers(0, 4, 2000)].tobytes().decode()
    (tmp_path / "reference.fasta").write_text(f">chr1\n{chr1}\n>chr2\n{chr2}\n")
    read = chr2[500:700]
    (tmp_path / "reads.fastq").write_text(f"@r0\n{read}\n+\n{'I' * 200}\n")
    (tmp_path / "candidates.paf").write_text(
        "r0\t200\t0\t200\t+\tchr2\t2000\t500\t700\t200\t200\t60\n")
    pg, preads = pio.load_dataset(tmp_path)
    jg, jreads = jio.load_dataset(tmp_path)
    assert fields(pg) == fields(jg) and fields(preads) == fields(jreads)
    assert preads[0].locations[0].start_in_reference == 3500


FASTA_TRAPS = (
    "junk before header\n"
    ">chr1 with spaces in desc\r\n"
    "ACGT ACGT\n"
    "\n"
    "TT\r\n"
    ">chr2\n"
    "GG GG"  # no trailing newline
)
FASTQ_TRAPS = (
    "@read1 x\r\n"
    "ACGTACGT\r\n"
    "+\n"
    "@@@@@@@@\n"  # a quality line starting with '@' must not resync
    "stray line\n"
    "  @read2\n"  # header with leading whitespace
    " ACGT \n"    # content with surrounding whitespace
    "+\n"
    "!!!!\n"
    "@read3\n"
    "AC"          # truncated record at EOF
)


def _seeded_fasta(seed):
    rng = np.random.default_rng(seed)
    chars = np.frombuffer(b"ACGTacgtN", np.uint8)
    out = []
    for k in range(int(rng.integers(1, 6))):
        body = chars[rng.integers(0, 9, int(rng.integers(0, 300)))]
        lines = [body[i : i + 60].tobytes().decode()
                 for i in range(0, len(body), 60)]
        nl = "\r\n" if rng.random() < 0.5 else "\n"
        out.append(f">s{k} d {seed}{nl}" + nl.join(lines) + nl)
    return "".join(out)


def _seeded_fastq(seed):
    rng = np.random.default_rng(seed)
    chars = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for k in range(int(rng.integers(1, 20))):
        body = chars[rng.integers(0, 4, int(rng.integers(1, 200)))]
        seq = body.tobytes().decode()
        qual = "@" * len(seq) if rng.random() < 0.3 else "I" * len(seq)
        out.append(f"@r{k} x\n{seq}\n+\n{qual}\n")
    return "".join(out)


@pytest.mark.parametrize("kind,text", [
    ("fasta", FASTA_TRAPS), ("fastq", FASTQ_TRAPS),
    ("fasta", _seeded_fasta(1)), ("fasta", _seeded_fasta(2)),
    ("fastq", _seeded_fastq(3)), ("fastq", _seeded_fastq(4)),
    ("fasta", ""), ("fastq", "")])
def test_parsers_match_jax_on_traps(tmp_path, kind, text):
    """Headers before the first record, CRLF, spaces in content, a quality
    line that starts with '@', stray lines, surrounding whitespace and a
    record cut at the end of the file."""
    p = tmp_path / f"t.{kind}"
    p.write_bytes(text.encode())
    got = getattr(pio, f"read_{kind}")(p)
    assert fields(got) == fields(getattr(jio, f"read_{kind}")(p))
    if text is FASTQ_TRAPS:
        assert [(r.description, r.content) for r in got] == [
            ("read1x", "ACGTACGT"), ("read2", "ACGT"), ("read3", "AC")]
    if text is FASTA_TRAPS:
        assert (got[0].description, got[0].content) == (
            "chr1 with spaces in desc", "ACGTACGTTT")


def test_parsers_universal_newlines_and_nonascii(tmp_path):
    fa = tmp_path / "cr.fasta"
    fa.write_bytes(b">c\nAC\rGT\n>d\rTTTT\r")
    assert fields(pio.read_fasta(fa)) == fields(jio.read_fasta(fa)) == [
        {"description": "c", "content": "ACGT"},
        {"description": "d", "content": "TTTT"}]
    fq = tmp_path / "cr.fastq"
    fq.write_bytes(b"@r1\rACGT\r+\r!!!!\r@r2\rGG\r+\r!!\r")
    assert fields(pio.read_fastq(fq)) == fields(jio.read_fastq(fq))
    ua = tmp_path / "u.fasta"
    ua.write_bytes(b">s\xc3\xa9q\nACGT\n")
    assert fields(pio.read_fasta(ua)) == fields(jio.read_fasta(ua)) == [
        {"description": "s\u00e9q", "content": "ACGT"}]


@pytest.mark.parametrize("kw", [{}, {"with_truth": True},
                                {"with_truth": True, "decoys": 1.5}])
def test_write_dataset_bytes_match_jax(tmp_path, kw):
    for mod, out in ((psim, "p"), (jsim, "j")):
        ds = mod.simulate_dataset(genome_len=30_000, num_reads=16,
                                  read_len=500, seed=7, **kw)
        mod.write_dataset(ds, tmp_path / out)
    for f in ("reference.fasta", "reads.fastq", "candidates.maf"):
        assert ((tmp_path / "p" / f).read_bytes()
                == (tmp_path / "j" / f).read_bytes()), f
    pds = psim.simulate_dataset(genome_len=30_000, num_reads=16,
                                read_len=500, seed=7, **kw)
    jds = jsim.simulate_dataset(genome_len=30_000, num_reads=16,
                                read_len=500, seed=7, **kw)
    assert fields(pds.reads) == fields(jds.reads)
    assert pds.truth == jds.truth
    if kw:
        assert ptools.maf_truth_rows(str(tmp_path / "p" / "candidates.maf")) \
            == pds.truth


def test_multichrom_genome_and_decoy_reads_match_jax():
    pg = psim.random_multichrom_genome(200_000, n_chroms=5, seed=3)
    jg = jsim.random_multichrom_genome(200_000, n_chroms=5, seed=3)
    assert fields(pg) == fields(jg)
    for with_truth in (False, True):
        p = psim.simulate_reads(pg, 10, 400, seed=4, with_truth=with_truth,
                                decoys=2.0)
        j = jsim.simulate_reads(jg, 10, 400, seed=4, with_truth=with_truth,
                                decoys=2.0)
        if with_truth:
            assert p[1] == j[1]
            p, j = p[0], j[0]
        assert fields(p) == fields(j)
        assert len({loc.chromosome for r in p for loc in r.locations}) > 1
