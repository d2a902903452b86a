"""The port's `tests` and `cpu_baseline` CLIs, in-process with --device=cpu,
against the JAX package's CLIs and library.

Scraped lines (accuracy rows, PASSED names, the timing lines' formats)
and the alignments of the performance test are compared exactly. Both
CLIs must refuse to run without a card unless --device=cpu is given.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

import scrooge_tpu_torch as st
from scrooge_tpu import api as japi
from scrooge_tpu import io as jio
from scrooge_tpu.cli import baseline_cli as jbase
from scrooge_tpu.cli import options as jopt
from scrooge_tpu.cli import tests_cli as jtests
from scrooge_tpu.config import AlignConfig as JaxAlignConfig
from scrooge_tpu_torch import api as papi
from scrooge_tpu_torch.cli import baseline_cli as pbase
from scrooge_tpu_torch.cli import options as popt
from scrooge_tpu_torch.cli import tests_cli as ptests

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "real_format")
SIM = ["--simulated=4,200", "--threads=128", "--accuracy", "--cigar"]
ACCURACY_ALGS = ["exact", "affine", "banded", "gact", "wfa", "sw",
                 "genasm_xla", "genasm_pyref"]


@pytest.fixture(autouse=True)
def restore_algorithm_log():
    """Both CLIs set api.enabled_algorithm_log; put it back."""
    saved = (papi.enabled_algorithm_log, japi.enabled_algorithm_log)
    yield
    papi.enabled_algorithm_log, japi.enabled_algorithm_log = saved


def run_main(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def jax_accuracy():
    """The JAX cpu_baseline's accuracy lines, one run per algorithm."""
    saved = japi.enabled_algorithm_log
    try:
        return {alg: run_main(jbase.main, SIM + [f"--algorithms={alg}"])[1]
                for alg in ACCURACY_ALGS}
    finally:
        japi.enabled_algorithm_log = saved


@pytest.mark.parametrize("argv", [
    ["--a", "--b=1", "--c="], ["--x=y=z", "--x"], [], ["plain", "--k=v"]])
def test_options_match_jax(argv):
    pa, ja = popt.scan_args(argv), jopt.scan_args(argv)
    assert pa == ja
    for name in ("--a", "--b", "--c", "--x", "--k", "plain", "--missing"):
        assert popt.get_flag(pa, name)[0].name == \
            jopt.get_flag(ja, name)[0].name
        st_p, v_p = popt.get_value(pa, name, "dflt")
        st_j, v_j = jopt.get_value(ja, name, "dflt")
        assert (st_p.name, v_p) == (st_j.name, v_j)
    for allowed in (["--a", "--b", "--c"], ["--x"], []):
        assert popt.check_options(pa, allowed) == \
            jopt.check_options(ja, allowed)


@pytest.mark.parametrize("alg", ACCURACY_ALGS)
def test_baseline_accuracy_lines_match_jax(alg, jax_accuracy):
    rc, out, _ = run_main(pbase.main, SIM + [f"--algorithms={alg}",
                                             "--device=cpu"])
    assert rc == 0
    assert out == jax_accuracy[alg]
    assert re.search(r"^pair_idx=0 score=(-?\d+) cigar=(\S+) read=([ACGT]+) "
                     r"reference=([ACGT]+)$", out, re.M), out


def test_genasm_device_on_cpu_prints_jax_xla_lines(jax_accuracy):
    rc, out, _ = run_main(pbase.main, SIM + ["--algorithms=genasm_device",
                                             "--device=cpu"])
    assert rc == 0 and out == jax_accuracy["genasm_xla"]


def test_baseline_benchmark_format_and_wfa_lm(capsys):
    rc = pbase.main(["--simulated=4,200", "--threads=128",
                     "--algorithms=exact,wfa_lm,genasm_device",
                     "--device=cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    for alg in ("exact", "wfa_lm", "genasm_device"):
        assert re.search(rf"^{alg}: \d+\.\d\d aligns/second$", out, re.M), out
    assert "128 threads" in out
    rc = pbase.main(SIM + ["--algorithms=wfa_lm,exact", "--device=cpu"])
    cap = capsys.readouterr()
    assert rc == 0 and "wfa_lm skipped" in cap.err
    assert cap.out.count("pair_idx=") == 4


def test_help_texts(capsys):
    assert ptests.main(["--badflag"]) == 0
    out = capsys.readouterr().out
    assert "--unit_tests" in out and "--reference=" in out
    assert "--device=[cuda|cpu]" in out
    assert pbase.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "--algorithms=" in out and "--scoring=" in out
    for name, engine in (("genasm_device", "the CUDA kernel"),
                         ("genasm_xla", "the plain torch engine on the CPU"),
                         ("genasm_pyref", "the scalar oracle")):
        assert f"{name} ({engine}" in out
    assert pbase.main(["--device=tpu"]) == 0  # an unknown device: help
    assert "--threads=" in capsys.readouterr().out


def test_device_info(capsys):
    assert ptests.main(["--device_info_only", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^\d+ visible device\(s\):", out), out
    assert re.search(r'^idx=0 name="cpu" platform=cpu$', out, re.M), out


def test_unit_tests_pass_with_jax_names():
    rc, out, _ = run_main(ptests.main, ["--unit_tests", "--device=cpu"])
    assert rc == 0, out
    assert "FAILED" not in out
    jrc, jout, _ = run_main(jtests.main, ["--unit_tests"])
    assert jrc == 0
    names = re.findall(r"^PASSED (\S+)$", out, re.M)
    assert names == re.findall(r"^PASSED (\S+)$", jout, re.M)
    assert len(names) == 5


def _by_pair(reads, alignments):
    keys = [(r.description, loc.start_in_reference) for r in reads
            for loc in r.locations]
    assert len(keys) == len(alignments) == len(set(keys))
    return {k: (a.edit_distance, a.cigar) for k, a in zip(keys, alignments)}


@pytest.mark.parametrize("name", ["ont_maf", "ilmn_paf"])
def test_performance_test_matches_jax(name, capsys):
    d = os.path.join(DATA, name)
    seeds = os.path.join(d, "candidates." + name[-3:])
    run = ptests.performance_test(
        os.path.join(d, "reference.fasta"), os.path.join(d, "reads.fastq"),
        seeds, st.AlignConfig(batch_tile=128), torch.device("cpu"))
    out = capsys.readouterr().out
    assert "FAILED" not in out
    assert re.search(r"^align_all\(\) took \d+ms \(data transfers, "
                     r"conversion, kernel and post-processing\)$", out, re.M)
    assert re.search(r"^CPU kernel took \d+ms$", out, re.M)
    assert re.search(r"^CPU kernel ran at \d+ aligns/second$", out, re.M)
    assert set(run.stage_ns) == {"reference", "reads_seeds", "shape",
                                 "align", "check"}
    lens = [len(r.content) for r in run.reads]
    assert lens == sorted(lens, reverse=True)
    assert all(loc.strand for r in run.reads for loc in r.locations)
    assert run.stats.num_pairs == len(run.alignments) == {"ont_maf": 7,
                                                          "ilmn_paf": 9}[name]

    genome, reads = jio.load_dataset(d)
    for read in reads:
        read.locations = [l for l in read.locations if l.strand]
    reads = [r for r in reads if r.locations]
    want = japi.align_reads(genome, reads, JaxAlignConfig(backend="xla",
                                                          batch_tile=128))
    assert _by_pair(run.reads, run.alignments) == _by_pair(reads, want)


def test_cpu_performance_test_lines_and_verbose_log(capsys):
    d = os.path.join(DATA, "ilmn_paf")
    rc = ptests.main(["--cpu_performance_test", "--verbose",
                      f"--reference={d}/reference.fasta",
                      f"--reads={d}/reads.fastq",
                      f"--seeds={d}/candidates.paf"])
    cap = capsys.readouterr()
    assert rc == 0 and "FAILED" not in cap.out
    assert 'idx=0 name="cpu" platform=cpu' in cap.out  # = --device=cpu
    assert re.search(r"^CPU kernel ran at \d+ aligns/second$", cap.out, re.M)
    assert re.search(r"^core algorithm ran at \d+ aligns/second$", cap.err,
                     re.M), cap.err
    assert "Sanity checking alignments..." in cap.err
    assert papi.enabled_algorithm_log is True  # restored by the fixture


def test_simulated_cap_inflation_and_profile(tmp_path, capsys):
    """--simulated with --read_length_cap and --dataset_inflation, traced
    with --profile: the reads are capped, doubled and sorted, and the
    alignments equal the library path's on the same reads."""
    run = ptests.performance_test(
        None, None, None, st.AlignConfig(batch_tile=128),
        torch.device("cpu"), profile_dir=str(tmp_path / "trace"),
        simulated="4,200", read_length_cap=150, dataset_inflation=2)
    assert "FAILED" not in capsys.readouterr().out
    assert len(run.reads) == 8 and max(len(r.content) for r in run.reads) \
        == 150
    genome, _ = ptests.load_simulated("4,200")
    want = st.align_reads(genome, run.reads, st.AlignConfig(batch_tile=128),
                          device="cpu")
    assert [(a.edit_distance, a.cigar) for a in run.alignments] == \
        [(a.edit_distance, a.cigar) for a in want]
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "align_reads" for e in events)


@pytest.mark.parametrize("main,argv", [
    (ptests.main, ["--unit_tests"]), (ptests.main, ["--device_info_only"]),
    (ptests.main, ["--simulated=2,100"]),
    (pbase.main, ["--simulated=2,100", "--algorithms=exact"])])
def test_no_fallback_without_a_card(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(argv)


@pytest.mark.parametrize("module", ["tests_cli", "baseline_cli"])
def test_no_fallback_exit_code(module):
    """With CUDA hidden, a run without --device=cpu exits non-zero and
    prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    argv = (["--unit_tests"] if module == "tests_cli"
            else ["--simulated=2,100", "--algorithms=exact", "--accuracy"])
    out = subprocess.run(
        [sys.executable, "-m", f"scrooge_tpu_torch.cli.{module}", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "PASSED" not in out.stdout and "pair_idx" not in out.stdout
    assert "torch.cuda.is_available() is False" in out.stderr
