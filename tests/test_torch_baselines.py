"""The port's CPU baselines, WFA family and CIGAR helpers against the JAX
package's on 20 seeded pairs of 50-300 bp (and the empty edge cases).

Every comparison is exact: scores, distances, CIGAR strings and the
helpers' integers and tuples.
"""

import numpy as np
import pytest

from scrooge_tpu import baselines as jb
from scrooge_tpu import cigar as jc
from scrooge_tpu import wfa as jw
from scrooge_tpu_torch import baselines as pb
from scrooge_tpu_torch import cigar as pc
from scrooge_tpu_torch import wfa as pw

BASES = np.frombuffer(b"ACGT", np.uint8)


def _mutate(rng, seq, rate):
    out = []
    for c in seq:
        r = rng.random()
        if r < rate / 3:
            continue  # deletion
        if r < 2 * rate / 3:
            out.append(BASES[rng.integers(0, 4)])  # insertion
        out.append(BASES[rng.integers(0, 4)] if r > 1 - rate / 3 else c)
    return bytes(out).decode()


def _pairs():
    """20 (text, query) pairs: queries of 50-300 bp at 2-15 % errors
    against a text 0-40 chars longer, then the empty cases."""
    rng = np.random.default_rng(2024)
    out = []
    for _ in range(20):
        m = int(rng.integers(50, 301))
        text = BASES[rng.integers(0, 4, m + int(rng.integers(0, 41)))]
        query = _mutate(rng, text[:m].tobytes(), float(rng.uniform(0.02,
                                                                   0.15)))
        out.append((text.tobytes().decode(), query))
    return out + [("", "ACGT"), ("ACGT", ""), ("", ""), ("A", "T")]


PAIRS = _pairs()

# (name, call on a module pair (baselines, wfa)); each returns what the
# CLI reads of it
FUNCS = {
    "exact_semiglobal": lambda b, w, t, q: b.exact_semiglobal(t, q),
    "affine_semiglobal": lambda b, w, t, q: b.affine_semiglobal(t, q),
    "affine_semiglobal_scoring": lambda b, w, t, q: b.affine_semiglobal(
        t, q, 1, 3, 5, 1),
    "banded_semiglobal": lambda b, w, t, q: b.banded_semiglobal(t, q),
    "banded_semiglobal_band1": lambda b, w, t, q: b.banded_semiglobal(
        t, q, initial_band=1),
    "gact_tiled": lambda b, w, t, q: b.gact_tiled(t[: len(q)], q),
    "gact_tiled_small_tiles": lambda b, w, t, q: b.gact_tiled(
        t[: len(q)], q, T=64, O=16),
    "local_affine": lambda b, w, t, q: b.local_affine(t, q),
    "semiglobal_distance": lambda b, w, t, q: b.semiglobal_distance(t, q),
    "wfa_global": lambda b, w, t, q: w.wfa_global(t[: len(q)], q),
    "wfa_semiglobal": lambda b, w, t, q: w.wfa_semiglobal(t, q),
    "wfa_distance": lambda b, w, t, q: w.wfa_distance(t, q),
    "wfa_distance_global": lambda b, w, t, q: w.wfa_distance(
        t[: len(q)], q, semiglobal=False),
    "baselines_reexport_wfa": lambda b, w, t, q: b.wfa_semiglobal(
        t, q, x=1, o=0, e=1),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_baseline_matches_jax(name):
    fn = FUNCS[name]
    for t, q in PAIRS:
        assert fn(pb, pw, t, q) == fn(jb, jw, t, q), (name, t, q)


def test_semiglobal_cigars_are_valid():
    for t, q in PAIRS:
        ed, cigar = pb.exact_semiglobal(t, q)
        pc.validate_cigar(cigar, ed, t, q)
        assert pb.semiglobal_distance(t, q) == ed
        assert pb.banded_semiglobal(t, q)[0] == ed


def _cigars():
    out = []
    for t, q in PAIRS:
        out += [pb.exact_semiglobal(t, q)[1], pb.affine_semiglobal(t, q)[1],
                pb.local_affine(t, q)[1]]
    return out + ["5M2I3M", "1=", ""]


@pytest.mark.parametrize("helper", ["parse_cigar", "merge_runs",
                                    "runs_to_cigar", "affine_score",
                                    "edits_in_cigar", "aligned_pairs"])
def test_cigar_helpers_match_jax(helper):
    for cigar in _cigars():
        if helper == "parse_cigar":
            got, want = pc.parse_cigar(cigar), jc.parse_cigar(cigar)
        elif helper == "merge_runs":
            runs = pc.parse_cigar(cigar) * 2
            got, want = pc.merge_runs(runs), jc.merge_runs(runs)
        elif helper == "runs_to_cigar":
            runs = pc.parse_cigar(cigar)
            got, want = pc.runs_to_cigar(runs), jc.runs_to_cigar(runs)
            assert got == cigar
        elif helper == "affine_score":
            got = [pc.affine_score(cigar), pc.affine_score(cigar, 1, 3, 5, 1)]
            want = [jc.affine_score(cigar), jc.affine_score(cigar, 1, 3, 5, 1)]
        elif helper == "edits_in_cigar":
            got, want = pc.edits_in_cigar(cigar), jc.edits_in_cigar(cigar)
        else:
            got = list(pc.aligned_pairs(cigar, 7))
            want = list(jc.aligned_pairs(cigar, 7))
        assert got == want, (helper, cigar)


def _variants(rng, cigar):
    """Seeded corruptions of a valid CIGAR: a count off by one, an op
    swapped, a run dropped or added, runs merged into 'M', stray
    characters, leading zeros."""
    runs = pc.parse_cigar(cigar) if cigar else []
    out = [cigar, cigar + "1I", cigar + "1D", "0=" + cigar, "3Q" + cigar,
           "01" + cigar if cigar else "01=", cigar + "x", " " + cigar,
           pc.runs_to_cigar([(c, "M" if op in "=X" else op)
                             for c, op in runs])]
    for _ in range(12):
        r = [list(x) for x in runs] or [[1, "="]]
        k = int(rng.integers(0, len(r)))
        what = int(rng.integers(0, 4))
        if what == 0:
            r[k][0] = max(0, r[k][0] + int(rng.choice([-1, 1])))
        elif what == 1:
            r[k][1] = "=XIDM"[int(rng.integers(0, 5))]
        elif what == 2:
            del r[k]
        else:
            r.insert(k, [int(rng.integers(1, 4)), "=XID"[int(rng.integers(
                0, 4))]])
        out.append("".join(f"{c}{op}" for c, op in r))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_validate_cigar_matches_jax_on_broken_cigars(seed):
    """The oracle accepts and rejects the same CIGARs as the JAX one, with
    the same message, on lowercase, mixed-case and offset inputs too."""
    rng = np.random.default_rng(seed)
    for t, q in PAIRS:
        ed, cigar = pb.exact_semiglobal(t, q)
        off = int(rng.integers(0, 5))
        cases = [(t, q, 0), (t.lower(), q, 0), ("ACG"[:off] + t, q, off)]
        for text, query, start in cases:
            for c in _variants(rng, cigar):
                for e in (ed, ed + 1, ed - 1):
                    res = []
                    for mod in (pc, jc):
                        try:
                            mod.validate_cigar(c, e, text, query, start)
                            res.append(None)
                        except mod.CigarError as err:
                            res.append(str(err))
                    assert res[0] == res[1], (c, e, start)
                    assert pc.is_valid_cigar(c, e, text, query, start) == \
                        (res[0] is None)


EDGE_CASES = [
    ("4=", 0, "ACGT", "ACGT", -4),          # a negative start wraps
    ("4=", 0, "ACGTAC", "ACGT", -2),        # ... past the end: IndexError
    ("2=", 0, "ACGT", "GT", -6),
    ("1D4=", 0, "ACGT", "ACGT", -5),
    ("4X", 4, "acgt", "ACGT", 0),           # X on a case-only difference
    ("4M", 4, "acgt", "ACGT", 0),           # M counts case differences
    ("\u0664=", 0, "ACGT", "ACGT", 0),      # a non-ASCII digit
    ("2=1X1=", 1, "AC\u00e9T", "AC\u00c9T", 0),  # non-ASCII case folding
    ("2=1X1=", 1, "AC\u00dfT", "ACST", 0),  # an upper case of two chars
    ("99999999999999999999=", 0, "ACGT", "ACGT", 0),
    ("4=99999999999999999999D", 0, "ACGT", "ACGT", 0),
    ("", 0, "ACGT", "", 0),
    ("", 0, "ACGT", "A", 0),
    ("1I", 1, "", "A", 0),
    ("1=", 0, "", "A", 0),
    ("1=", 0, "ACGT", "A", 9),
    ("1=", 0, "ACGT", "T", 3),
]


@pytest.mark.parametrize("case", EDGE_CASES, ids=range(len(EDGE_CASES)))
def test_validate_cigar_matches_jax_on_edge_inputs(case):
    """Negative and past-the-end starts, non-ASCII digits and bases, huge
    counts and empty inputs: the same verdict, message and exception type
    as the JAX oracle."""
    res = []
    for mod in (pc, jc):
        try:
            mod.validate_cigar(*case)
            res.append(None)
        except (mod.CigarError, IndexError) as err:
            res.append((type(err).__name__, str(err)))
    assert res[0] == res[1], case


def test_edlib_matches_jax():
    """Compared only where a real edlib is reachable here."""
    if not (pb.edlib_available() and jb.edlib_available()):
        pytest.skip("no edlib (PyPI package or SCROOGE_EDLIB_SRC + g++)")
    for t, q in PAIRS:
        assert pb.edlib_semiglobal(t, q) == jb.edlib_semiglobal(t, q)
        assert pb.edlib_semiglobal_cigar(t, q) == jb.edlib_semiglobal_cigar(
            t, q)


def test_edlib_unavailable_without_sources(tmp_path, monkeypatch):
    """A missing or broken SCROOGE_EDLIB_SRC reports edlib unavailable
    instead of raising; the cigar path then raises ImportError."""
    for src in ("", str(tmp_path / "nowhere"), str(tmp_path)):
        (tmp_path / "edlib.cpp").write_text("this is not C++\n")
        monkeypatch.setenv("SCROOGE_EDLIB_SRC", src)
        monkeypatch.setattr(pb, "_edlib_lib_cache", [])
        assert pb._edlib_lib() is None
        with pytest.raises(ImportError):
            pb.edlib_semiglobal_cigar("ACGT", "ACG")
