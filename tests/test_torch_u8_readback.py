"""The port's uint8 run readback and the last public helpers, on the CPU.

Where 31 < tb_limit <= 63, ``api._build_alignments`` compacts each pair's
runs to one byte (op << 6 | count), reads them back and decodes them with
``native.format_cigars_u8`` (strings) or ``native.extract_runs`` on uint8
(packed), as the JAX package does (scrooge_tpu/api.py:550-586). At
96/96/49 and 128/128/65, over two tiles of 128, both interfaces, strings
and packed, must equal the JAX package's ``backend="xla"`` and the port's
own uint16 readback, packed runs bit for bit, with half its readback
bytes. The native helpers must equal the JAX package's on the same
arrays, and so must ``pyref.DEBUG`` / ``TracebackDeadEnd``; the port's
``kernel_time.kernel_rate`` needs a card. Inputs come from seeded numpy;
every comparison is exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scrooge_tpu  # noqa: E402
from scrooge_tpu import native as jax_native  # noqa: E402
from scrooge_tpu import pyref as jax_pyref  # noqa: E402
from scrooge_tpu.datamodel import (CandidateLocation as JaxLoc,  # noqa: E402
                                   Genome as JaxGenome, Read as JaxRead)
import scrooge_tpu_torch as st  # noqa: E402
from scrooge_tpu_torch import api, native, pyref  # noqa: E402
from scrooge_tpu_torch.profiling import kernel_time  # noqa: E402
from torch_pipeline_cases import (jax_cfg, key, mapped, reads,  # noqa: E402
                                  seqs)
from torch_threads import one_intra_op_thread  # noqa: E402,F401

TILE = 128
PAIRS = TILE + 72  # two tiles, the second partial
CONFIGS = {"96-96-49": (96, 96, 49), "128-128-65": (128, 128, 65)}


def _jax_packed(packed):
    return (packed.edit_distances, packed.run_offsets, packed.runs)


def _port_calls(c, packed):
    W, K, O = c["wko"]
    cfg = st.AlignConfig(W=W, K=K, O=O, batch_tile=TILE)
    a, sa = st.align_pairs(c["texts"], c["queries"], cfg, return_stats=True,
                           return_packed=packed, device="cpu")
    b, sb = st.align_reads(st.Genome(content=c["genome"]),
                           reads(st.Read, st.CandidateLocation, c["queries"],
                                 c["locs"]),
                           cfg, return_stats=True, return_packed=packed,
                           device="cpu")
    return {"pairs": (a, sa), "reads": (b, sb)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    W, K, O = wko = CONFIGS[request.param]
    texts, queries = seqs(np.random.default_rng(W + 1), PAIRS, 60, 170,
                          0.04)
    genome, locs = mapped(texts)
    cfg = jax_cfg(W, K, O)
    jreads = reads(JaxRead, JaxLoc, queries, locs)
    jgenome = JaxGenome(content=genome)
    c = dict(wko=wko, texts=texts, queries=queries, genome=genome, locs=locs)
    c["want"] = {
        "pairs": (key(scrooge_tpu.align_all(texts, queries, config=cfg)),
                  _jax_packed(scrooge_tpu.align_all(
                      texts, queries, config=cfg, return_packed=True))),
        "reads": (key(scrooge_tpu.align_all(jgenome, jreads, config=cfg)),
                  _jax_packed(scrooge_tpu.align_all(
                      jgenome, jreads, config=cfg, return_packed=True)))}
    # the port's uint8 readback, then its uint16 one (the limit lowered)
    c["u8"] = {m: _port_calls(c, m) for m in (False, True)}
    saved = api.U8_MAX_TB_LIMIT
    api.U8_MAX_TB_LIMIT = 31
    try:
        c["u16"] = {m: _port_calls(c, m) for m in (False, True)}
    finally:
        api.U8_MAX_TB_LIMIT = saved
    return c


@pytest.mark.parametrize("interface", ["pairs", "reads"])
def test_u8_readback_equals_jax_and_u16(case, interface):
    assert 31 < st.AlignConfig(W=case["wko"][0],
                               O=case["wko"][2]).tb_limit <= 63
    strs, _ = case["u8"][False][interface]
    packed, _ = case["u8"][True][interface]
    want_strs, want_packed = case["want"][interface]
    assert key(strs) == want_strs
    assert key(packed.to_alignments()) == want_strs
    for got, want in zip(_jax_packed(packed), want_packed):
        np.testing.assert_array_equal(got, np.asarray(want))
    # the uint16 readback: the same strings, the same runs bit for bit
    assert key(case["u16"][False][interface][0]) == want_strs
    for got, want in zip(_jax_packed(packed),
                         _jax_packed(case["u16"][True][interface][0])):
        np.testing.assert_array_equal(got, want)
    assert sum(ed > 0 for ed, _ in want_strs) > len(want_strs) // 2


@pytest.mark.parametrize("mode", [False, True])
def test_readback_bytes_count_one_byte_a_run(case, mode):
    """Each tile reads back one chunk of (its most runs, its lanes): one
    byte an entry, half the uint16 readback's bytes."""
    packed, _ = case["u8"][True]["pairs"]
    _, stats = case["u8"][mode]["pairs"]
    _, stats16 = case["u16"][mode]["pairs"]
    assert stats.retried_pairs == 0
    runs = np.diff(packed.run_offsets)
    qlen = [len(q) for q in case["queries"]]
    order = sorted(range(len(qlen)), key=lambda i: -qlen[i])
    entries = sum(max(int(runs[order[t : t + TILE]].max()), 1)
                  * len(order[t : t + TILE])
                  for t in range(0, len(order), TILE))
    assert stats.readback_bytes == entries
    assert stats16.readback_bytes == 2 * entries


def _runs(rng, cap, B, dtype):
    """(cap, B) random runs of ``dtype`` and per-lane totals, some past
    cap, some zero."""
    bits = 6 if dtype == np.uint8 else 12
    ops = rng.integers(0, 4, (cap, B))
    cnt = rng.integers(0, 1 << bits, (cap, B))
    entries = ((ops << bits) | cnt).astype(dtype)
    totals = rng.integers(0, cap + 3, B).astype(np.int32)
    totals[::7] = 0
    return entries, totals


@pytest.mark.parametrize("cap,B", [(1, 1), (9, 37), (40, 300)])
def test_native_helpers_equal_jax(cap, B):
    rng = np.random.default_rng(cap * 1000 + B)
    e8, t8 = _runs(rng, cap, B, np.uint8)
    assert native.format_cigars_u8(e8, t8) == jax_native.format_cigars_u8(
        e8, t8)
    np.testing.assert_array_equal(native.extract_runs(e8, t8),
                                  jax_native.extract_runs(e8, t8))
    e16, t16 = _runs(rng, cap, B, np.uint16)
    np.testing.assert_array_equal(native.extract_runs(e16, t16),
                                  jax_native.extract_runs(e16, t16))
    assert native.format_cigars(e16, t16) == jax_native.format_cigars(e16,
                                                                      t16)
    for weights in ((), (1, 3, 5, 1)):
        np.testing.assert_array_equal(
            native.affine_scores(e16, t16, *weights),
            jax_native.affine_scores(e16, t16, *weights))
    # a column slice, as a readback chunk is cut: the same as its copy
    part = e8[:, B // 3 :]
    assert native.format_cigars_u8(part, t8[B // 3 :]) == \
        native.format_cigars_u8(part.copy(), t8[B // 3 :])


def test_native_helpers_raise_instead_of_falling_back():
    with pytest.raises(TypeError):
        native.extract_runs(np.zeros((2, 3), np.int32),
                            np.zeros(3, np.int32))
    out = np.zeros(4, np.uint16)
    with pytest.raises(ValueError):  # the destination runs past out
        native.scatter_runs(np.arange(5, dtype=np.uint16), [0], [0], [5],
                            out, np.array([0, 5]))
    with pytest.raises(ValueError):  # the source runs past flat
        native.scatter_runs(np.arange(2, dtype=np.uint16), [1], [0], [2],
                            out, np.array([0, 2]))
    with pytest.raises(ValueError):
        native.scatter_runs(np.arange(2, dtype=np.uint16), [0], [0], [2],
                            out.astype(np.int32), np.array([0, 2]))


def _random_cases(seed, count, max_len=180):
    """(text, query) pairs, each query its text with edits (seqs)."""
    rng = np.random.default_rng(seed)
    texts, queries = seqs(rng, count, 1, max_len, 0.06)
    return list(zip(texts, queries))


def test_pyref_debug_dead_end_detection(monkeypatch):
    """The SCROOGE_DEBUG traceback guard (genasm_cpu.cpp:307-385), as
    tests/test_engine_pallas.py checks the JAX package's: with it on,
    clean tables trace back as with it off; a table with no zero raises
    TracebackDeadEnd, as the JAX oracle does, where without it an '='
    run comes out."""
    assert issubclass(pyref.TracebackDeadEnd, AssertionError)
    cfg = st.AlignConfig()
    cases = _random_cases(31, 10)
    plain = [pyref.align_pair(t, q, cfg) for t, q in cases]
    monkeypatch.setattr(pyref, "DEBUG", True)
    checked = [pyref.align_pair(t, q, cfg) for t, q in cases]
    assert plain == checked
    assert plain == [jax_pyref.align_pair(t, q, scrooge_tpu.AlignConfig())
                     for t, q in cases]

    class _NoZeros:
        def zero_at(self, *a):
            return False

    for sene in (True, False):
        c = st.AlignConfig(store_entries_not_edges=sene)
        with pytest.raises(pyref.TracebackDeadEnd):
            pyref.genasm_tb(4, 4, _NoZeros(), 2, c)
        monkeypatch.setattr(jax_pyref, "DEBUG", True)
        with pytest.raises(jax_pyref.TracebackDeadEnd):
            jax_pyref.genasm_tb(4, 4, _NoZeros(), 2, scrooge_tpu.AlignConfig(
                store_entries_not_edges=sene))
        monkeypatch.setattr(jax_pyref, "DEBUG", False)
    monkeypatch.setattr(pyref, "DEBUG", False)
    assert pyref.genasm_tb(4, 4, _NoZeros(), 2, cfg)[3] == \
        jax_pyref.genasm_tb(4, 4, _NoZeros(), 2, scrooge_tpu.AlignConfig())[3]


def test_pyref_debug_reads_the_environment():
    """SCROOGE_DEBUG=1 at import turns the guard on."""
    probe = ("import scrooge_tpu_torch.pyref as p, sys; "
             "sys.stdout.write(repr(p.DEBUG))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env={**os.environ, "SCROOGE_DEBUG": "1"},
                         timeout=120)
    assert out.stdout == "True", out.stderr


def test_kernel_rate_needs_a_card():
    """kernel_rate, the median of kernel_rate_samples, refuses tensors
    off a card, as stage_mapped refuses a device that is not one."""
    cfg = st.AlignConfig(batch_tile=128)
    g = st.Genome(content="ACGT" * 100)
    r = st.Read(description="r", content="ACGT" * 20,
                locations=[st.CandidateLocation(start_in_reference=0)])
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_time.stage_mapped(g, [r], cfg, "cpu")
    z = torch.zeros(1, dtype=torch.int32)
    staged = (cfg, 8, (z, z.long(), z, torch.zeros((1, 2), dtype=torch.int32),
                       z), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_time.kernel_rate(staged)
