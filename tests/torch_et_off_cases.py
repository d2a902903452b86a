"""Pairs and calls shared by the early-termination tests
(``tests/test_torch_et_off.py``, ``tests/test_torch_et_off_wide.py``):
the same pairs, made with numpy from a seed, through the port's
``align_pairs`` on the CPU with ET off and on and the JAX package's with
``backend="xla"`` and ET off."""

import numpy as np

import scrooge_tpu
import scrooge_tpu_torch as st
from scrooge_tpu.config import AlignConfig as JaxAlignConfig
from scrooge_tpu_torch.utils.simulate import _mutate

ACGT = np.array(list("ACGT"))


def make_pairs(seed, count=12):
    """``count`` pairs of at most 300 bp: pair 0 a read of 300 (every
    batch's longest, so that a call with pair 3 replaced compiles the
    same JAX shapes), pair 1 an empty read, pair 2 a text that runs out
    6 chars before its read (within K = 16 of the last window), the rest
    related at 2-8 % errors (utils.simulate's mutator)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(count):
        text = rng.integers(0, 4, int(rng.integers(150, 301)), dtype=np.uint8)
        read = _mutate(rng, text, float(rng.uniform(0.02, 0.08)))[:300]
        if k == 0:
            text = rng.integers(0, 4, 300, dtype=np.uint8)
            read = _mutate(rng, text, 0.04)[:300]
            read = np.concatenate([read, rng.integers(0, 4, 300 - len(read),
                                                      dtype=np.uint8)])
        elif k == 1:
            read = read[:0]
        elif k == 2:
            text = text[:250]
            read = np.concatenate([_mutate(rng, text, 0.02),
                                   rng.integers(0, 4, 6, dtype=np.uint8)])
        out.append(("".join(ACGT[text]), "".join(ACGT[read])))
    return out


def outputs(pairs, W, K, O):
    """(port ET off, port ET on, JAX xla ET off), each as (ed, cigar)
    lists, or the AlignmentError message each raised."""
    texts, reads = [t for t, _ in pairs], [q for _, q in pairs]

    def run(fn):
        try:
            return [(a.edit_distance, a.cigar) for a in fn()]
        except (st.AlignmentError, scrooge_tpu.api.AlignmentError) as e:
            return str(e)

    return [
        run(lambda: st.align_pairs(texts, reads, st.AlignConfig(
            W=W, K=K, O=O, early_termination=et), device="cpu"))
        for et in (False, True)] + [
        run(lambda: scrooge_tpu.align_pairs(texts, reads, JaxAlignConfig(
            W=W, K=K, O=O, early_termination=False, backend="xla",
            batch_tile=128)))]


def check_config(W, K, O, unrelated=False):
    """make_pairs(W + K) through outputs(): the three equal, with enough
    edits to matter; with ``unrelated``, pair 3 made an unrelated pair of
    200 bp, which no window aligns within a small K, and the same
    AlignmentError from all three."""
    pairs = make_pairs(W + K)
    assert max(len(q) for _, q in pairs) == 300
    off, on, jax_off = outputs(pairs, W, K, O)
    assert off == on == jax_off
    assert off[1] == (0, "") and sum(ed > 0 for ed, _ in off) >= 8
    if unrelated:
        rng = np.random.default_rng(K)
        pairs[3] = tuple("".join(ACGT[rng.integers(0, 4, 200)])
                         for _ in range(2))
        off, on, jax_off = outputs(pairs, W, K, O)
        assert off == on == jax_off == (
            f"pair 3: no alignment within K={K} edits per window (W={W})")
