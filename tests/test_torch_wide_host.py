"""The wide window kernel's warp code on the host, under sanitizers.

``tests/wide_host.cpp`` includes ``csrc/genasm_windows_wide.cu`` itself
(not a copy) and stands in for the card's shuffles: the 32 threads of a
warp (32/G sub-groups of G, the rows of a pass of its one pair) run in
lockstep over an array. It is built with g++ under AddressSanitizer and
UBSan into ``scrooge_tpu_torch/_build/`` and run on ragged batches at W =
320 and 512 (G = 8, four rows a pass), 640 (G = 16, two) and 1100 and
2048 (G = 32, one); ed, failed, every count and the runs must equal the
plain engine's (``engine.align_windows_plain``). The batch has an empty
read, a text that runs out first (n = 0 in its later windows), related
pairs and unrelated ones, which fail at K = 64; the edge cases add pairs
with an exact number of substitutions in their first window (a hit in
the last row of a pass, or at K inside a pass when K is not a multiple of
the rows a pass) and a read of 100 chars (s = W - m not a multiple of 64).
Skips where g++ or the sanitizer runtime is absent.
"""

import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scrooge_tpu_torch.buildcache import BUILD_DIR  # noqa: E402
from scrooge_tpu_torch.config import AlignConfig  # noqa: E402
from scrooge_tpu_torch.ops import _cuda, compact, engine, pack  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

HARNESS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "wide_host.cpp")
FLAGS = ("-std=c++17", "-O1", "-g", "-Wall", "-Wextra", "-Werror",
         "-Wno-unknown-pragmas", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all", "-fno-omit-frame-pointer")


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The harness built once per content under BUILD_DIR/wide_host/, or
    a skip where g++ cannot link and run a sanitized program."""
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
    src = os.path.join(_cuda.CSRC, _cuda.GENASM_WINDOWS_WIDE.source)
    with open(src) as f, open(HARNESS) as g:
        key = hashlib.sha256("\0".join((f.read(), g.read(), *FLAGS)).encode()
                             ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, "wide_host", key)
    exe = os.path.join(out, "wide_host")
    if not os.path.exists(exe):
        os.makedirs(out, exist_ok=True)
        tmp = exe + f".{os.getpid()}.tmp"
        proc = subprocess.run([gxx, *FLAGS, "-I", _cuda.CSRC, HARNESS, "-o",
                               tmp], capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
        os.replace(tmp, exe)
    return exe


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
    """The harness's BatchResult for the engine's arguments."""
    B = int(plen.shape[0])
    head = np.array([cfg.W, cfg.K, cfg.O, maxw, B], np.int32)
    head64 = np.array([tw.numel(), pw.shape[1]], np.int64)
    stdin = b"".join(np.ascontiguousarray(x).tobytes() for x in (
        head, head64, tw.numpy(), base.numpy(), tlen.numpy(), pw.numpy(),
        plen.numpy()))
    proc = subprocess.run([exe], input=stdin, capture_output=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr.decode(errors="replace")[-4000:]
    NE = engine.entry_rows(cfg)
    sizes = [4 * B, 4 * B, 2 * maxw * NE * B, 4 * maxw * B]
    assert len(proc.stdout) == sum(sizes)
    out, at = [], 0
    for n, dt in zip(sizes, (np.int32, np.int32, np.int16, np.int32)):
        out.append(torch.from_numpy(np.frombuffer(proc.stdout[at: at + n],
                                                  dt).copy()))
        at += n
    ed, failed, entries, counts = out
    return engine.BatchResult(ed, failed, entries.view(maxw, NE, B),
                              counts.view(maxw, B))


def assert_same(got, want):
    """ed, failed and counts, then the runs after compaction."""
    assert torch.equal(got.edit_distance, want.edit_distance)
    assert torch.equal(got.failed, want.failed)
    assert torch.equal(got.counts, want.counts)
    cap = int(want.counts.sum(0).max().item()) + 1
    cg, tg = compact.compact_entries(got.entries, got.counts, cap)
    cw, tw = compact.compact_entries(want.entries, want.counts, cap)
    assert torch.equal(tg, tw) and torch.equal(cg, cw)


def _case_id(wko, B, unrelated, subs):
    """W-K-O-B-unrelated, then the substitution counts, if any."""
    return "-".join(map(str, (*wko, B, unrelated))) + "".join(
        f"-s{n}" for n in subs)


@pytest.mark.parametrize("wko, B, unrelated, subs", [pytest.param(
    *case, id=_case_id(*case)) for case in [
    ((320, 320, 161), 13, 0, ()),   # G = 8: four rows a pass
    ((512, 512, 257), 11, 0, ()),
    ((512, 64, 257), 11, 4, ()),    # FAIL_TB lanes
    ((512, 512, 0), 7, 0, ()),      # COLS = W+1: the start column stored
    ((640, 640, 0), 5, 0, ()),      # G = 16, every R word stored
    ((1100, 1100, 551), 3, 0, ()),  # G = 32, one row a pass
    # hits in the last row of a pass of four (rows 3, 7, 11), and at 0
    ((512, 512, 257), 9, 0, (3, 7, 11, 0)),
    # K = 6 inside the pass of rows 4..7: a hit at K, FAIL_TB at K
    ((512, 6, 257), 8, 2, (6, 5)),
    # G = 16, two rows a pass: a hit in a pass's last row (3) and at K = 5
    ((640, 5, 0), 8, 2, (3, 5)),
    # G = 32 at W = 2048, a small K so that R stays small on the host
    ((2048, 32, 1025), 5, 0, (31,)),
]])
def test_lane_group_matches_plain(harness, wko, B, unrelated, subs):
    W, K, O = wko
    cfg = AlignConfig(W=W, K=K, O=O)
    # the edge batches' other related pairs are exact copies, within any K
    args = ragged_batch(W + B, B, int(1.6 * W), int(1.4 * W), unrelated,
                        rate=0.0 if subs else 0.06, subs=subs,
                        tb=cfg.tb_limit)
    maxw = cfg.max_windows(int(args[4].max()))
    got = run_harness(harness, cfg, maxw, *args)
    want = engine.align_windows_plain(cfg, maxw, *args)
    if unrelated:
        assert int((want.failed & engine.FAIL_TB != 0).sum()) > 0
    assert int((want.failed == 0).sum()) >= B - unrelated - 1
    for k, nsub in enumerate(subs):  # the batch is what it claims
        assert int(want.edit_distance[3 + k]) == nsub
        assert int(want.failed[3 + k]) == 0
    if subs:
        assert int(args[4][3 + len(subs)]) == 100
        assert int(want.failed[3 + len(subs)]) == 0
    assert_same(got, want)
