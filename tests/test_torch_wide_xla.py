"""Windows wider than 256 on the CPU against the JAX package's XLA engine.

At W > 256 the JAX package aligns every pair on ``engine_xla`` (its
Pallas kernel cannot hold the window); ``st.align_pairs(...,
device="cpu")`` runs the port's plain engine. The same pairs, made from
a seed, must give the same edit distances and CIGARs, bit for bit, at
W/K/O = 320/320/161 and 512/512/257. Its own file: a JAX compile at
these widths takes about a minute on the CPU.
"""

import random

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scrooge_tpu  # noqa: E402
import scrooge_tpu_torch as st  # noqa: E402
from scrooge_tpu.config import AlignConfig as JaxAlignConfig  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401


def _pairs(seed, count):
    """Related pairs of 200..700 bp (about 4 % substitutions and indels),
    an empty read and a text shorter than its read."""
    rng = random.Random(seed)
    pairs = []
    for _ in range(count):
        t = "".join(rng.choice("ACGT") for _ in range(rng.randint(200, 700)))
        q = []
        for c in t[: rng.randint(150, len(t))]:
            r = rng.random()
            if r < 0.013:
                continue
            if r < 0.026:
                q.append(rng.choice("ACGT"))
            q.append(c if r >= 0.04 or r < 0.026 else rng.choice("ACGT"))
        pairs.append((t, "".join(q)))
    pairs += [(pairs[0][0], ""), (pairs[1][0][:120], pairs[1][1][:180])]
    return pairs


@pytest.mark.parametrize("wko", [(320, 320, 161), (512, 512, 257)],
                         ids=lambda w: "-".join(map(str, w)))
def test_align_pairs_match_xla_engine(wko):
    W, K, O = wko
    pairs = _pairs(W, 10)
    texts, queries = [t for t, _ in pairs], [q for _, q in pairs]
    want = scrooge_tpu.align_pairs(
        texts, queries, JaxAlignConfig(W=W, K=K, O=O, backend="xla",
                                       batch_tile=128))
    got = st.align_pairs(texts, queries, st.AlignConfig(W=W, K=K, O=O),
                         device="cpu")
    assert [(a.edit_distance, a.cigar) for a in got] == [
        (a.edit_distance, a.cigar) for a in want]
    assert sum(a.edit_distance > 0 for a in got) >= 5
