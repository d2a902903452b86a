"""Helpers of the host harnesses of the kernels
(``tests/test_torch_windows_host.py``, ``tests/test_torch_wide_host.py``
and ``tests/test_torch_tokens_host.py``), and the dense run layouts the
token kernel's tests on the host and on the card share.

Each harness (``tests/windows_host.cpp``, ``tests/wide_host.cpp``,
``tests/tokens_host.cpp``) includes kernel sources of
``scrooge_tpu_torch/csrc/`` themselves, is built with g++ under
AddressSanitizer and UBSan into ``scrooge_tpu_torch/_build/<name>/`` once
per content, reads its kernel's arguments on stdin and writes its outputs
on stdout.
"""

import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from scrooge_tpu_torch.buildcache import BUILD_DIR
from scrooge_tpu_torch.ops import _cuda, compact, engine, pack
from scrooge_tpu_torch.utils.simulate import edge_pairs

TESTS = os.path.dirname(os.path.abspath(__file__))
OP_EQ, OP_X, OP_I, OP_D = 0, 1, 2, 3
# early termination on and off, as test parameters
ET = [pytest.param(True, id="eton"), pytest.param(False, id="etoff")]
FLAGS = ("-std=c++17", "-O1", "-g", "-Wall", "-Wextra", "-Werror",
         "-Wno-unknown-pragmas", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all", "-fno-omit-frame-pointer")


def build_harness(tmp_path_factory, name: str) -> str:
    """``tests/<name>.cpp`` built once per content (its own, that of
    tests/warp_host.h and that of every file under csrc/) under
    BUILD_DIR/<name>/, or a skip where g++ cannot link and run a sanitized
    program."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("sanitizer_probe")
    (d / "probe.cpp").write_text("int main() { return 0; }\n")
    proc = subprocess.run([gxx, "-fsanitize=address,undefined", "-o",
                           str(d / "probe"), str(d / "probe.cpp")],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0 or subprocess.run(
            [str(d / "probe")], capture_output=True, timeout=60).returncode:
        pytest.skip("the AddressSanitizer / UBSan runtime is not available: "
                    + proc.stderr.strip()[-200:])
    harness = os.path.join(TESTS, f"{name}.cpp")
    h = hashlib.sha256("\0".join(FLAGS).encode())
    for path in [harness, os.path.join(TESTS, "warp_host.h")] + sorted(
            os.path.join(_cuda.CSRC, f) for f in os.listdir(_cuda.CSRC)):
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, name, h.hexdigest()[:16])
    exe = os.path.join(out, name)
    if not os.path.exists(exe):
        os.makedirs(out, exist_ok=True)
        tmp = exe + f".{os.getpid()}.tmp"
        proc = subprocess.run([gxx, *FLAGS, "-I", _cuda.CSRC, harness, "-o",
                               tmp], capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
        os.replace(tmp, exe)
    return exe


def edge_batch(cfg, B):
    """``utils.simulate.edge_pairs`` as the engine's packed arguments,
    ragged in B (not a multiple of a 64-thread block)."""
    text, tlen, pattern, plen = edge_pairs(cfg.W + cfg.O + cfg.K, B, 300,
                                           280, cfg.tb_limit)
    tw = pack.pack_2bit(torch.from_numpy(text))
    base = torch.arange(B, dtype=torch.int64) * (tw.shape[1] * 16)
    return (tw, base, torch.from_numpy(tlen),
            pack.pack_2bit(torch.from_numpy(pattern)),
            torch.from_numpy(plen))


def ragged_batch(seed, B, T, P, unrelated=0, rate=0.06, subs=(), tb=0):
    """B pairs as packed words: related pairs (substitutions and indels)
    of ragged lengths, the last ``unrelated`` of them drawn apart; pair 0
    has an empty read, pair 1 a text of 40 chars against a longer read,
    pair 2 its text with char 10 deleted (the traceback of its first
    window walks to the window's end with an edit left, one text char
    ahead of the read: at O = 0 it reads R's column W). With ``subs``,
    pair 3+k is its text with exactly subs[k] substitutions, all within
    the first window's ``tb`` traced chars, and the pair after them a read
    of 100 chars."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, (B, T), dtype=np.uint8)
    pattern = np.zeros((B, P), np.uint8)
    tlen = np.full(B, T, np.int32)
    plen = np.zeros(B, np.int32)
    for b in range(B):
        r = rng.random(T)
        keep = text[b][r >= rate / 3]
        keep = np.where(rng.random(len(keep)) < rate / 3,
                        rng.integers(0, 4, len(keep)), keep)
        ins = np.flatnonzero(rng.random(len(keep)) < rate / 3)
        q = np.insert(keep, ins, rng.integers(0, 4, len(ins)))
        if b >= B - unrelated:
            q = rng.integers(0, 4, len(q))
        q = q[: int(rng.integers(P // 2, P + 1))]
        pattern[b, : len(q)] = q
        plen[b] = len(q)
    plen[0] = 0
    tlen[1] = 40
    pattern[2], plen[2] = np.delete(text[2], 10)[:P], P
    for k, nsub in enumerate(subs):
        b = 3 + k
        q = text[b, :P].copy()
        at = rng.choice(np.arange(8, tb - 8), nsub, replace=False)
        q[at] = (q[at] + rng.integers(1, 4, nsub)) % 4
        pattern[b], plen[b] = q, P
    if subs:
        plen[3 + len(subs)] = 100
        pattern[3 + len(subs), :100] = text[3 + len(subs), :100]
    tw = pack.pack_2bit(torch.from_numpy(text))
    base = torch.arange(B, dtype=torch.int64) * (tw.shape[1] * 16)
    return (tw, base, torch.from_numpy(tlen),
            pack.pack_2bit(torch.from_numpy(pattern)),
            torch.from_numpy(plen))


def run_harness(exe, cfg, maxw, tw, base, tlen, pw, plen):
    """The harness's BatchResult for the engine's arguments, with the
    config's early termination."""
    B = int(plen.shape[0])
    head = np.array([cfg.W, cfg.K, cfg.O, maxw, B,
                     int(cfg.early_termination)], np.int32)
    head64 = np.array([tw.numel(), pw.shape[1]], np.int64)
    stdin = b"".join(np.ascontiguousarray(x).tobytes() for x in (
        head, head64, tw.numpy(), base.numpy(), tlen.numpy(), pw.numpy(),
        plen.numpy()))
    proc = subprocess.run([exe], input=stdin, capture_output=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr.decode(errors="replace")[-4000:]
    NE = engine.entry_rows(cfg)
    sizes = [4 * B, 4 * B, 2 * maxw * NE * B, 4 * maxw * B]
    types = [np.int32, np.int32, np.int16, np.int32]
    if engine.num_words(cfg.W) == 1 and "windows_host" in exe:
        sizes.append(16)  # the one-word kernel's row counters
        types.append(np.int64)
    assert len(proc.stdout) == sum(sizes)
    out, at = [], 0
    for n, dt in zip(sizes, types):
        out.append(torch.from_numpy(np.frombuffer(proc.stdout[at: at + n],
                                                  dt).copy()))
        at += n
    ed, failed, entries, counts = out[:4]
    return engine.BatchResult(ed, failed, entries.view(maxw, NE, B),
                              counts.view(maxw, B),
                              rows=out[4] if len(out) > 4 else None)


def assert_same(got, want):
    """ed, failed and counts, then the runs after compaction; the row
    counters where the harness returns them."""
    if got.rows is not None:
        assert torch.equal(got.rows, want.rows)
    assert torch.equal(got.edit_distance, want.edit_distance)
    assert torch.equal(got.failed, want.failed)
    assert torch.equal(got.counts, want.counts)
    cap = int(want.counts.sum(0).max().item()) + 1
    cg, tg = compact.compact_entries(got.entries, got.counts, cap)
    cw, tw = compact.compact_entries(want.entries, want.counts, cap)
    assert torch.equal(tg, tw) and torch.equal(cg, cw)


def assert_subs_batch(want, cfg, subs):
    """The batch is what ragged_batch claims: pair 3+k has distance
    subs[k] (or fails FAIL_TB where subs[k] > K), and the pair after them
    a read of 100 chars that aligns."""
    for k, nsub in enumerate(subs):
        if nsub > cfg.K:
            assert int(want.failed[3 + k]) & engine.FAIL_TB
        else:
            assert int(want.edit_distance[3 + k]) == nsub
            assert int(want.failed[3 + k]) == 0
    if subs:
        assert int(want.failed[3 + len(subs)]) == 0


def _run(op, count):
    return (op << engine.ENTRY_OP_SHIFT) | count


def random_layout(seed, wcap, B, ne=64, max_count=31, empty=0.2):
    """(entries, counts): each window a random number of runs in [0, ne],
    ``empty`` of the windows none; ops at random, counts in [1,
    max_count]; the rows past a window's count hold garbage."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, ne + 1, (wcap, B)).astype(np.int32)
    counts[rng.random((wcap, B)) < empty] = 0
    ops = rng.integers(0, 4, (wcap, ne, B))
    cnts = rng.integers(1, max_count + 1, (wcap, ne, B))
    entries = _run(ops, cnts).astype(np.int16)
    return entries, counts


def layout_with(lanes, ne=64, wcap=None):
    """(entries, counts) from each lane's windows, a list of [(op, count)]
    lists; the rows past a window's runs hold garbage."""
    wcap = wcap or max(len(w) for w in lanes)
    B = len(lanes)
    entries = np.full((wcap, ne, B), _run(OP_D, 7), np.int16)
    counts = np.zeros((wcap, B), np.int32)
    for b, windows in enumerate(lanes):
        for w, runs in enumerate(windows):
            counts[w, b] = len(runs)
            for e, (op, n) in enumerate(runs):
                entries[w, e, b] = _run(op, n)
    return entries, counts
