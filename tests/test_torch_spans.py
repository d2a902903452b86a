"""Spans and counters of the port's tile pipeline, on the CPU.

``profiling/spans.py`` times each host stage of ``align_reads`` /
``align_pairs`` into a field of the call's AlignStats and, only under a
torch profiler, records it as a ``scrooge.<stage>`` range named with its
call's id and tile's index. ``profiling/pipeline.py``'s ``idle_by_span``
and ``span_sums`` read such ranges from a chrome trace; here they read a
trace written by hand, whose answers are worked out in the comments.
"""

import json
import sys

import pytest
import torch

import scrooge_tpu_torch as st
from scrooge_tpu_torch import api
from scrooge_tpu_torch.profiling import pipeline, spans
from scrooge_tpu_torch.utils.simulate import simulate_dataset
from torch_threads import one_intra_op_thread  # noqa: F401

# 150 pairs in tiles of 128: two tiles, so the worker runs
CFG = st.AlignConfig(W=64, K=64, O=33, batch_tile=128)
FIELDS = ("prep_ns", "dispatch_ns", "kernel_wait_ns", "edges_ns",
          "pair_python_ns")
# every stage of the tile pipeline, on the caller's thread or the worker's
CALLER = ("call", "pairs", "genome", "budget", "tile_prep", "pack",
          "upload", "launch", "caller_wait", "finish")
WORKER = ("kernel_wait", "compact", "readback", "format", "results")


@pytest.fixture(scope="module")
def ds():
    return simulate_dataset(genome_len=20_000, num_reads=150, read_len=150,
                            accuracy=0.95, seed=11)


def _align(ds, interface, packed):
    if interface == "reads":
        return st.align_reads(ds.genome, ds.reads, CFG, return_stats=True,
                              return_packed=packed, device="cpu")
    g = ds.genome.content
    texts = [g[loc.start_in_reference:
               loc.start_in_reference + len(r.content) + 32]
             for r in ds.reads for loc in r.locations]
    queries = [r.content for r in ds.reads for _ in r.locations]
    return st.align_pairs(texts, queries, CFG, return_stats=True,
                          return_packed=packed, device="cpu")


@pytest.mark.parametrize("interface,packed", [("reads", False),
                                              ("reads", True),
                                              ("pairs", False),
                                              ("pairs", True)])
def test_stage_fields_are_counted(ds, interface, packed):
    """Every stage that runs on the CPU counts time; the allocators are
    not watched without a card."""
    _, stats = _align(ds, interface, packed)
    for f in FIELDS + ("caller_wait_ns", "compact_ns"):
        assert getattr(stats, f) > 0, f
    assert stats.allocator_misses == 0
    assert (stats.format_ns > 0) != packed  # strings only
    assert not hasattr(stats, "postprocess_ns")


def test_add_sums_the_new_fields():
    names = FIELDS + ("caller_wait_ns", "allocator_misses")
    a = api.AlignStats(num_pairs=5, **{f: k + 1 for k, f in
                                       enumerate(names)})
    b = api.AlignStats(num_pairs=9, **{f: 10 for f in names})
    a.add(b)
    assert a.num_pairs == 5
    assert [getattr(a, f) for f in names] == [11 + k for k in
                                              range(len(names))]
    assert "allocator_misses=" in a.breakdown()
    assert a.breakdown().startswith("prep=")


def test_a_call_with_no_pair_is_all_edge():
    _, stats = st.align_pairs([], [], CFG, return_stats=True, device="cpu")
    assert stats.edges_ns > 0
    assert stats.kernel_wait_ns == stats.core_ns == stats.prep_ns == 0


def _ranges(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith(spans.PREFIX)]


def test_profiler_trace_holds_every_stage(ds, tmp_path):
    """Under the profiler each stage is a range named with the call's id
    and the tile's index; the caller's stages lie inside scrooge.call on
    its thread, and a tile's readback and format ranges never overlap on
    the worker's."""
    path = str(tmp_path / "trace.json")
    with spans.profile(cuda=False) as prof:
        with torch.profiler.record_function("align_reads"):
            _align(ds, "reads", False)
    prof.export_chrome_trace(path)
    ranges = _ranges(path)
    parsed = [spans.parse(e["name"]) + (e,) for e in ranges]
    stages = {p[0] for p in parsed}
    assert stages >= {spans.PREFIX + s for s in CALLER + WORKER}
    assert len({p[1] for p in parsed}) == 1  # one call id
    assert {p[2] for p in parsed if p[0] == "scrooge.pack"} == {0, 1}
    (call,) = [e for s, _, _, e in parsed if s == "scrooge.call"]
    c0, c1 = call["ts"], call["ts"] + call["dur"]
    for s, _, _, e in parsed:
        if s[len(spans.PREFIX):] in CALLER:
            assert e["tid"] == call["tid"], s
            assert c0 <= e["ts"] and e["ts"] + e["dur"] <= c1, s
    worker = {e["tid"] for s, _, _, e in parsed
              if s == "scrooge.kernel_wait"}
    assert worker and call["tid"] not in worker
    formats = [(t, e) for s, _, t, e in parsed if s == "scrooge.format"]
    readbacks = [(t, e) for s, _, t, e in parsed if s == "scrooge.readback"]
    assert formats and readbacks
    for tile, r in readbacks:
        assert r["tid"] in worker
        for t, f in formats:
            if t == tile and f["tid"] == r["tid"]:
                assert (r["ts"] + r["dur"] <= f["ts"]
                        or f["ts"] + f["dur"] <= r["ts"])


def test_format_and_readback_fields_are_their_ranges(ds, tmp_path):
    """A strings call's format_ns and readback_ns are each the summed
    durations of their ranges (within 1 % plus 50 us a range, the
    profiler's own cost around a span): neither is derived from the
    other. A long switch interval keeps the other thread from taking the
    GIL between a range's edge and its span's clock reading."""
    path = str(tmp_path / "trace.json")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1.0)
    try:
        with spans.profile(cuda=False) as prof:
            _, stats = _align(ds, "reads", False)
    finally:
        sys.setswitchinterval(interval)
    prof.export_chrome_trace(path)
    for stage, ns in (("format", stats.format_ns),
                      ("readback", stats.readback_ns)):
        durs = [e["dur"] * 1e3 for e in _ranges(path)
                if spans.parse(e["name"])[0] == spans.PREFIX + stage]
        assert durs and ns > 0, stage
        assert ns == pytest.approx(sum(durs), rel=0.01,
                                   abs=50e3 * len(durs)), stage


def test_no_profiler_no_record_function(ds, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(spans, "record_function", refuse)
    out, stats = _align(ds, "pairs", False)
    assert len(out) == stats.num_pairs and stats.dispatch_ns > 0


def test_labels_parse_back():
    assert spans.parse(spans.label("pack", 3, 1)) == ("scrooge.pack", 3, 1)
    assert spans.parse(spans.label("call", 12)) == ("scrooge.call", 12,
                                                    None)
    assert spans.parse("scrooge.budget") == ("scrooge.budget", None, None)
    assert spans.allocator_count([]) == 0


def _x(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur}


@pytest.fixture()
def hand_trace(tmp_path):
    """One call in a 100 us window. Caller (tid 1): call 1-99, pairs
    2-10, launch 10-20, caller_wait 30-90. Worker (tid 2): kernel_wait
    20-70, format 70-90 holding readback 71-76. Device: kernels 15-60
    and 50-70 (10 us on both streams at once), a copy 74-76. Busy
    15-70 and 74-76; idle 0-15, 70-74 and 76-100, 43 us."""
    c = "call=7"
    events = [
        _x("align_reads", 0, 100),
        _x(f"scrooge.call {c}", 1, 98),
        _x(f"scrooge.pairs {c}", 2, 8),
        _x(f"scrooge.launch {c} tile=0", 10, 10),
        _x(f"scrooge.caller_wait {c} tile=0", 30, 60),
        _x(f"scrooge.kernel_wait {c} tile=0", 20, 50, tid=2),
        _x(f"scrooge.format {c} tile=0", 70, 20, tid=2),
        _x(f"scrooge.readback {c} tile=0", 71, 5, tid=2),
        _x("genasm_windows_kernel", 15, 45, tid=7, cat="kernel"),
        _x("genasm_windows_kernel", 50, 20, tid=8, cat="kernel"),
        _x("Memcpy DtoH", 74, 2, tid=8, cat="gpu_memcpy"),
        _x("aten::empty", 3, 1, cat="cpu_op"),
    ]
    path = tmp_path / "hand.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_idle_by_span_on_a_hand_written_trace(hand_trace):
    rep = pipeline.idle_by_span(hand_trace)
    assert rep.window_s == pytest.approx(100e-6)
    assert rep.idle_s == pytest.approx(43e-6)
    us = {t: {k: round(v * 1e6, 6) for k, v in by.items()}
          for t, by in rep.by_span.items()}
    # caller: 0-1 and 99-100 none, 1-2 and 90-99 call, 2-10 pairs, 10-15
    # launch, 70-74 and 76-90 caller_wait
    assert us["caller"] == {pipeline.NO_SPAN: 2, "scrooge.call": 10,
                            "scrooge.pairs": 8, "scrooge.launch": 5,
                            "scrooge.caller_wait": 18}
    # worker: 0-15 and 90-100 none, 70-71 and 76-90 format, 71-74
    # readback (the innermost)
    assert us["worker"] == {pipeline.NO_SPAN: 25, "scrooge.format": 15,
                            "scrooge.readback": 3}
    assert [(round(at * 1e6), round(n * 1e6)) for at, n, _ in rep.gaps] \
        == [(76, 24), (0, 15), (70, 4)]
    assert [g[2] for g in rep.gaps] == [
        {"caller": "scrooge.caller_wait", "worker": "scrooge.format"},
        {"caller": "scrooge.pairs", "worker": pipeline.NO_SPAN},
        {"caller": "scrooge.caller_wait", "worker": "scrooge.readback"}]
    assert rep.kernel_s == pytest.approx(65e-6)
    assert rep.kernel_union_s == pytest.approx(55e-6)


def test_span_sums_on_a_hand_written_trace(hand_trace):
    """Each thread's stages that no other stage holds, against the call's
    wall: the readback inside format counts once, in format."""
    (rec,) = pipeline.span_sums(hand_trace).values()
    assert rec["wall_s"] == pytest.approx(98e-6)
    got = {t: {k: round(v * 1e6, 6) for k, v in by.items()}
           for t, by in rec["threads"].items()}
    assert got == {"caller": {"scrooge.pairs": 8, "scrooge.launch": 10,
                              "scrooge.caller_wait": 60},
                   "worker": {"scrooge.kernel_wait": 50,
                              "scrooge.format": 20}}


def test_pipeline_trace_prints_the_idle_attribution(tmp_path, capsys):
    out = tmp_path / "p.csv"
    assert pipeline.main(["--device", "cpu", "--reads", "130",
                          "--read_len", "150", "--genome_len", "20000",
                          "--batch_tile", "128", "--trace", "--no_warmup",
                          "--out", str(out)]) == 0
    err = capsys.readouterr().err
    for mode in ("strings", "packed"):
        assert f"# {mode}: idle s by caller span: " in err
        assert f"# {mode}: idle s by worker span: " in err
        assert "caller stages" in err and "worker stages" in err
