"""The token kernel's warp code on the host, under sanitizers.

``tests/tokens_host.cpp`` includes ``csrc/genasm_tokens.cu`` itself (not
a copy) and stands in for the card's shuffles and ballots: the 32 threads
of a warp run in lockstep over an array. It is built with g++ under
AddressSanitizer and UBSan into ``scrooge_tpu_torch/_build/`` and run on
dense run layouts; every byte of each lane's row (its tokens, then the
zeros up to 2 * cap) and each lane's token count must equal the CPU torch
route's (``ops/tokens.lane_tokens_plain``) and, where JAX is installed,
the JAX package's (``scrooge_tpu/ops/tokens.py``). The harness fills the
rows and the warp's buffer with garbage first. The cases: a lane with no
runs, windows with no runs inside a lane (across the kernel's 32-window
chunks), an '=' run that ends a window before an edit that opens the
next, edit runs of 1, 2 and 31 (the extension token), '=' runs of up to
63 and run counts past 63 (the uint8 repack's truncation), full windows
of 64 rows, B not a multiple of 32, one window, and the plain engine's
results on related and unrelated pairs at 64/64/33. Skips where g++ or
the sanitizer runtime is absent.
"""

import functools
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scrooge_tpu_torch.config import AlignConfig  # noqa: E402
from scrooge_tpu_torch.ops import compact, engine, tokens  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401
from torch_window_harness import (OP_D, OP_EQ, OP_I, OP_X,  # noqa: E402
                                  build_harness, layout_with,
                                  random_layout, ragged_batch)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_harness(tmp_path_factory, "tokens_host")


def run_harness(exe, entries, counts, cap):
    """(out (B, 2 cap) uint8, lane_tot (B,) int32) of the harness."""
    wcap, ne, B = entries.shape
    capB = 2 * cap
    stdin = b"".join((np.array([wcap, ne, B], np.int32).tobytes(),
                      np.array([capB], np.int64).tobytes(),
                      entries.numpy().tobytes(), counts.numpy().tobytes()))
    proc = subprocess.run([exe], input=stdin, capture_output=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr.decode(errors="replace")[-4000:]
    assert len(proc.stdout) == B * capB + 4 * B
    out = np.frombuffer(proc.stdout[: B * capB], np.uint8).reshape(B, capB)
    return out, np.frombuffer(proc.stdout[B * capB:], np.int32)


def case_empty_lane():
    entries, counts = random_layout(1, 40, 64)
    counts[:, 0] = 0
    counts[:, 17] = 0
    return entries, counts


def case_empty_windows():
    """Lanes whose runs skip windows: inside a chunk, a whole chunk
    (windows 32..63) and its boundary (window 31 to 64)."""
    entries, counts = random_layout(2, 100, 40, empty=0.6)
    counts[5:9, 3] = 0
    counts[31:, 4] = 0
    counts[32:64, 5] = 0
    counts[32:64, 6] = 0
    counts[31, 6] = 0
    counts[64:, 7] = 0
    counts[:99, 8] = 0  # the lane's one window with runs is the last
    return entries, counts


def case_eq_before_edit_across_windows():
    """An '=' run that ends a window, before an edit that opens the next
    (and the next with runs, past an empty one; and across the 32-window
    chunk boundary), so the '=' is carried by the edit's token; beside it
    an '=' that ends a window before an '=' (bare)."""
    X, I, D, EQ = OP_X, OP_I, OP_D, OP_EQ
    lanes = [
        [[(EQ, 9), (X, 1), (EQ, 12)], [(I, 3), (EQ, 5)]],
        [[(EQ, 9)], [], [(D, 2), (EQ, 30)], [(EQ, 4), (X, 1)]],
        [[(EQ, 31)], [(EQ, 8), (I, 1)], [(X, 2)]],
        [[(X, 1)]] + [[]] * 30 + [[(EQ, 17)], [(D, 31), (EQ, 3)]],
        [[(EQ, 20)]] * 33 + [[(X, 5)]],
        [[(EQ, 6)]] * 32 + [[], [(I, 1), (EQ, 2)]],
    ]
    return layout_with(lanes)


def case_edit_counts():
    """Edit runs of 1 (no extension), 2 and 31 (extension tokens of 1 and
    30), after '=' runs of every kind, and at a lane's ends."""
    lanes = []
    for op in (OP_X, OP_I, OP_D):
        for n in (1, 2, 31):
            lanes.append([[(op, n), (OP_EQ, 5), (op, n)],
                          [(op, n)], [(OP_EQ, 63), (op, n), (op, n)]])
    return layout_with(lanes)


def case_eq_counts_to_63_and_past():
    """'=' runs of 1..63 (val has 5 bits: 32..63 spill into the tag) and
    runs of up to 4095 (the repack keeps the low 8 bits of op << 6 |
    count), bare and before edits."""
    entries, counts = random_layout(3, 20, 48, max_count=4095)
    eq = layout_with([[[(OP_EQ, n), (OP_X, 1)], [(OP_EQ, n)],
                       [(OP_EQ, 64 - n), (OP_D, n % 32 + 1)]]
                      for n in range(1, 64)], wcap=20)
    return (np.concatenate([entries, eq[0]], 2),
            np.concatenate([counts, eq[1]], 1))


def case_full_windows():
    """Every window of some lanes holds ne = 64 runs: the chunk's
    buffer full."""
    entries, counts = random_layout(4, 70, 33)
    counts[:, :5] = 64
    return entries, counts


def case_ragged_b():
    return random_layout(5, 37, 45)


def case_one_window():
    return random_layout(6, 1, 70)


def case_engine_pairs():
    """The plain engine at 64/64/33 on related pairs (substitutions and
    indels) and unrelated ones, which the decoys of a chained mix are."""
    cfg = AlignConfig(W=64, K=64, O=33)
    args = ragged_batch(64, 70, 1400, 1200, unrelated=30, rate=0.05)
    maxw = cfg.max_windows(int(args[4].max()))
    res = engine.align_windows_plain(cfg, maxw, *args)
    meta = compact.batch_meta(res).numpy()
    wcap = max(int(meta[4].max()), 1)
    assert int((meta[2] == 0).sum()) > 30  # related pairs align
    return res.entries[:wcap].numpy(), res.counts[:wcap].numpy()


CASES = {f.__name__[5:]: f for f in (
    case_empty_lane, case_empty_windows, case_eq_before_edit_across_windows,
    case_edit_counts, case_eq_counts_to_63_and_past, case_full_windows,
    case_ragged_b, case_one_window, case_engine_pairs)}


@functools.lru_cache(maxsize=None)
def harness_case(exe, case):
    """(entries, counts, cap, out, lane_tot): a case's layout, its cap (the
    largest lane's run total) and the harness's rows for it."""
    entries, counts = (torch.from_numpy(np.ascontiguousarray(a))
                       for a in CASES[case]())
    totals = counts.clamp(0, entries.shape[1]).sum(0)
    cap = max(int(totals.max()), 1)
    return (entries, counts, cap, *run_harness(exe, entries, counts, cap))


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_tokens_match_torch_route(harness, case):
    entries, counts, cap, got, got_tot = harness_case(harness, case)
    want, want_tot = tokens.lane_tokens_plain(entries, counts, cap)
    np.testing.assert_array_equal(got_tot, want_tot.numpy())
    np.testing.assert_array_equal(got, want.numpy())
    # the rows are the tokens, then zeros
    k = np.arange(2 * cap)[None, :]
    assert not got[k >= got_tot[:, None]].any()
    assert (got[k < got_tot[:, None]] != 0).all()
    assert got_tot.sum() > 0


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_tokens_match_jax(harness, case):
    """The same rows and totals against the JAX package's token route
    (scrooge_tpu/ops/tokens.py: compact_tokenize on the dense layout,
    then compact_tokens to the same 2 * cap columns)."""
    pytest.importorskip("jax")
    from scrooge_tpu.ops import tokens as jtokens

    entries, counts, cap, got, got_tot = harness_case(harness, case)
    toks, _, tot = jtokens.compact_tokenize(entries.numpy().view(np.uint16),
                                            counts.numpy(), cap, False)
    np.testing.assert_array_equal(got_tot, np.asarray(tot))
    np.testing.assert_array_equal(
        got, np.asarray(jtokens.compact_tokens(toks, 2 * cap)))
