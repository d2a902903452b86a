"""The port's bench (scrooge_tpu_torch/bench.py) on the CPU.

``python -m scrooge_tpu_torch.bench`` is the counterpart of the JAX
package's root bench.py: the same knobs, dataset and JSON keys, plus
``card``. Here it runs with BENCH_DEVICE=cpu on small datasets (the plain
engine, no kernel-only or staged pass): its knobs and refusals, its JSON
line, the output check that guards the line, and the stage-breakdown CSV
against the JAX bench's file, the JAX simulator and ``plots pipeline``.
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

import scrooge_tpu_torch as st
from scrooge_tpu_torch import bench
from scrooge_tpu_torch.api import AlignStats
from scrooge_tpu_torch.datamodel import Alignment
from scrooge_tpu_torch.profiling import kernel_time, pipeline, plots
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE = os.path.join(ROOT, "profile")
# a CPU run of 256 reads of 500 bp at W=64 (short reads)
SMALL = {"BENCH_DEVICE": "cpu", "BENCH_READS": "256",
         "BENCH_READ_LEN": "500", "BENCH_GENOME": "100000"}
TINY = {"BENCH_DEVICE": "cpu", "BENCH_READS": "128",
        "BENCH_READ_LEN": "200", "BENCH_GENOME": "50000"}


def _profile_state():
    return {f: os.stat(os.path.join(PROFILE, f)).st_mtime_ns
            for f in os.listdir(PROFILE)}


def _bench(mp, env):
    """bench.main() under ``env`` alone of the BENCH_ knobs: (rc, stdout,
    stderr)."""
    for name in [n for n in os.environ if n.startswith("BENCH_")]:
        mp.delenv(name)
    for name, value in env.items():
        mp.setenv(name, value)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main()
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """One bench run at SMALL with BENCH_PIPELINE_CSV set, and the state
    of profile/ before and after it."""
    csv_path = str(tmp_path_factory.mktemp("bench") / "pipeline.csv")
    before = _profile_state()
    with pytest.MonkeyPatch.context() as mp:
        rc, out, err = _bench(mp, {**SMALL, "BENCH_PIPELINE_CSV": csv_path})
    return dict(rc=rc, out=out, err=err, csv=csv_path, before=before,
                after=_profile_state())


def test_jax_bench_keys_are_the_ports():
    """The root bench.py's JSON keys are KEYS, CARD_KEYS and
    LONG_READ_KEYS, less the port's ``card``."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        src = f.read()
    block = src[src.index("    out = {"):src.index("print(json.dumps(out))")]
    jax_keys = set(re.findall(r'^\s+"(\w+)":', block, re.M)) | set(
        re.findall(r'out\["(\w+)"\]', block))
    port = {*bench.KEYS, *bench.CARD_KEYS, *bench.LONG_READ_KEYS}
    assert jax_keys == port - {"card"}


def test_tbcap_is_refused(monkeypatch):
    with pytest.raises(ValueError, match="BENCH_TBCAP=8"):
        _bench(monkeypatch, {**TINY, "BENCH_TBCAP": "8"})


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = {k: v for k, v in TINY.items() if k != "BENCH_DEVICE"}
    with pytest.raises(RuntimeError, match="is_available"):
        _bench(monkeypatch, env)
    with pytest.raises(RuntimeError, match="is_available"):
        _bench(monkeypatch, {**env, "BENCH_DEVICE": "cuda:0"})


def test_knobs_follow_the_jax_bench(monkeypatch):
    k = bench.knobs({"BENCH_DEVICE": "cpu"})
    assert (k.reads, k.read_len, k.genome_len, k.accuracy, k.decoys) == (
        32768, 10000, 1_000_000, 0.95, 0.0)
    assert (k.cfg.W, k.cfg.K, k.cfg.O, k.cfg.batch_tile,
            k.cfg.early_termination) == (64, 64, 33, 16384, True)
    assert k.kernel_tile == bench.KERNEL_TILE_LONG and not k.pipeline_csv
    k = bench.knobs({"BENCH_DEVICE": "cpu", "BENCH_W": "32",
                     "BENCH_READ_LEN": "150", "BENCH_GENOME": "1e5"})
    assert (k.cfg.W, k.cfg.K, k.cfg.O, k.genome_len) == (32, 32, 17, 100000)
    assert k.kernel_tile == bench.KERNEL_TILE_SHORT


def test_cpu_run_prints_one_json_line(small_run):
    assert small_run["rc"] == 0, small_run["err"]
    lines = small_run["out"].strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    # 500 bp: short reads, so no vs_baseline; no card, so no kernel-only
    # or staged pass
    assert set(line) == set(bench.KEYS)
    assert line["metric"] == "short_read_aligns_per_second"
    assert line["unit"] == "aligns/s" and line["card"] == "cpu"
    assert line["value"] == line["api_core_aligns_per_second"] > 0
    assert line["end_to_end_aligns_per_second"] > 0
    assert line["end_to_end_packed_aligns_per_second"] > 0
    assert line["link_h2d_mb_s"] is None and line["link_d2h_mb_s"] is None
    err = small_run["err"]
    assert "# warm-up: first call" in err
    assert "# checked: 16 pairs equal to pyref, 256 valid CIGARs" in err
    assert "# packed: prep=" in err and "retried=0" in err
    assert json.loads(err.split("# launches ")[1].splitlines()[0]) == {
        "end_to_end": {}}


@pytest.mark.parametrize("read_len", [999, 1000, 10000])
def test_metric_and_vs_baseline_follow_the_read_length(read_len):
    stats = AlignStats(num_pairs=100, core_ns=10**9, upload_bytes=10**6,
                       upload_ns=10**6, readback_bytes=10**6,
                       readback_ns=2 * 10**6)
    cpu = bench.result_line(read_len, stats, 2.0, 1.0, None, None, "cpu")
    card = bench.result_line(read_len, stats, 2.0, 1.0, [50e3, 75e3, 80e3],
                             (40.0, 60.0), "NVIDIA H100 80GB HBM3, 700.00 W")
    long_read = read_len >= 1000
    for line in (cpu, card):
        assert line["metric"] == ("long_read" if long_read
                                  else "short_read") + "_aligns_per_second"
        assert ("vs_baseline" in line) == long_read
        assert line["end_to_end_aligns_per_second"] == 50.0
        assert line["end_to_end_packed_aligns_per_second"] == 100.0
    assert cpu["value"] == 100.0 and card["value"] == 75e3
    assert set(card) == {*bench.KEYS, *bench.CARD_KEYS,
                         *(bench.LONG_READ_KEYS if long_read else ())}
    assert (card["kernel_aligns_min"], card["kernel_aligns_max"]) == (
        50e3, 80e3)
    assert (card["link_h2d_mb_s"], card["link_d2h_mb_s"]) == (1000.0, 500.0)
    if long_read:
        assert card["vs_baseline"] == round(75e3 / 25_004.0, 4)


def _corrupt(kind, target):
    """align_reads whose output is wrong at pair ``target``: in the
    strings only (packed disagrees), or in both the same way (an edit
    distance pyref disagrees with, or an '=' run turned into 'X', an
    invalid CIGAR)."""
    real = bench.align_reads

    def wrapped(*args, **kwargs):
        out, stats = real(*args, **kwargs)
        if kwargs.get("return_packed"):
            if kind == "pyref":
                out.edit_distances[target] += 1
            elif kind == "cigar":  # the first '=' run
                lo = out.run_offsets[target]
                j = lo + int(np.argmax(out.pair_runs(target) >> 12 == 0))
                out.runs[j] |= 1 << 12
        else:
            a = out[target]
            if kind in ("strings", "pyref"):
                out[target] = Alignment(a.cigar, a.edit_distance + 1)
            else:
                out[target] = Alignment(re.sub(r"(\d+)=", r"\1X", a.cigar,
                                               count=1), a.edit_distance)
        return out, stats

    return wrapped


@pytest.mark.parametrize("kind", ["strings", "pyref", "cigar"])
def test_a_corrupted_alignment_fails_the_run(monkeypatch, kind):
    k = bench.knobs(TINY)
    lens = [len(r.content) for r in bench.pair_reads(bench.dataset(k).reads)]
    sample, cigars = bench.check_sample(lens, bench.CHECK_PAIRS,
                                        bench.CHECK_CIGARS)
    # the longest read is held to pyref; for the CIGAR check a pair that
    # pyref does not see
    target = (sample[0] if kind != "cigar"
              else next(i for i in cigars if i not in sample))
    assert int(np.argmax(lens)) in sample and target in cigars
    monkeypatch.setattr(bench, "ROUNDS", 1)
    monkeypatch.setattr(bench, "align_reads", _corrupt(kind, target))
    rc, out, err = _bench(monkeypatch, TINY)
    assert rc == 1 and out == ""
    want = {"strings": "strings and packed output disagree",
            "pyref": f"pair {target} differs from pyref",
            "cigar": f"pair {target} has an invalid CIGAR"}[kind]
    assert f"# output check failed: bench: {want}" in err


def test_pipeline_csv_is_plotted_and_profile_untouched(small_run, tmp_path):
    assert small_run["rc"] == 0, small_run["err"]
    rows = plots._read_csv(small_run["csv"])
    assert list(rows[0]) == pipeline.HEADER
    assert [r["mode"] for r in rows] == ["strings", "packed"]
    assert all(int(r["pairs"]) == 256 and r["engine"] == "plain"
               and r["card"] == "cpu" and int(r["tiles"]) == 1
               for r in rows)
    plots.plot_pipeline(small_run["csv"], str(tmp_path / "pipeline.png"))
    assert (tmp_path / "pipeline.png").stat().st_size > 0
    assert small_run["after"] == small_run["before"]


def test_dataset_and_config_are_the_jax_benchs():
    """The same knobs give the JAX bench's dataset (its simulator, seed
    7), decoys included, and a config the JAX package accepts."""
    pytest.importorskip("jax")
    import dataclasses

    from scrooge_tpu.config import AlignConfig as JaxConfig
    from scrooge_tpu.utils.simulate import simulate_dataset

    k = bench.knobs({**TINY, "BENCH_READS": "32", "BENCH_DECOYS": "1.5"})
    port = bench.dataset(k)
    want = simulate_dataset(genome_len=50000, num_reads=32, read_len=200,
                            accuracy=0.95, seed=7, decoys=1.5)
    assert port.genome.content == want.genome.content
    assert [(r.content, [loc.start_in_reference for loc in r.locations])
            for r in port.reads] == [
        (r.content, [loc.start_in_reference for loc in r.locations])
        for r in want.reads]
    assert JaxConfig(**dataclasses.asdict(k.cfg)) == JaxConfig(
        W=64, K=64, O=33, early_termination=True, tb_cap_override=0,
        batch_tile=16384)
    # every (read, location) pair, in align_reads' order, one location each
    pairs = bench.pair_reads(port.reads)
    assert len(pairs) == sum(len(r.locations) for r in port.reads) > 32
    got = st.align_reads(port.genome, port.reads, k.cfg, device="cpu")
    assert got == st.align_reads(port.genome, pairs, k.cfg, device="cpu")


def test_kernel_tile_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        kernel_time.main(["--tiles", "128"])
