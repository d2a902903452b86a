"""Inputs and calls shared by the port's tile-pipeline tests.

``case`` makes pairs from a seed with numpy, over four tiles of TILE and
more, in two forms (unstructured pairs, and read mapping against the
texts joined into one genome), with the JAX package's ``backend="xla"``
results for both; ``port_calls`` runs the port's two interfaces on them,
strings and packed.
"""

import numpy as np

import scrooge_tpu
import scrooge_tpu_torch as st
from scrooge_tpu.config import AlignConfig as JaxAlignConfig
from scrooge_tpu.datamodel import (CandidateLocation as JaxLoc,
                                   Genome as JaxGenome, Read as JaxRead)

TILE = 128
PAIRS = 3 * TILE + 37  # four tiles, the last partial
DEVICES = {"cpu": "cpu", "mesh2": ["cpu", "cpu"]}
CODES = np.frombuffer(b"ACGT", np.uint8)


def seqs(rng, count, lo, hi, rate):
    """(texts, queries): each query a prefix of its text with
    substitutions, insertions and deletions at about ``rate`` each; every
    ninth query in lowercase, which both packages accept."""
    texts, queries = [], []
    for k in range(count):
        t = CODES[rng.integers(0, 4, int(rng.integers(lo, hi + 1)))]
        q = t[: int(rng.integers(lo // 2, len(t) + 1))]
        r = rng.random(len(q))
        q = np.where(r < rate, CODES[rng.integers(0, 4, len(q))], q)
        q = q[r < 1 - rate / 2]  # deletions
        ins = np.flatnonzero(rng.random(len(q)) < rate / 2)
        q = np.insert(q, ins, CODES[rng.integers(0, 4, len(ins))])
        q = q.tobytes().decode()
        texts.append(t.tobytes().decode())
        queries.append(q.lower() if k % 9 == 4 else q)
    return texts, queries


def key(alns):
    return [(a.edit_distance, a.cigar) for a in alns]


def mapped(texts, gap=7, unrelated=True):
    """The texts joined into a genome, with ``gap`` random bases between
    them; read i at its text's start, and every fifth read also at the
    next text's start (``unrelated``) or one base after its own. Returns
    (genome, locations)."""
    rng = np.random.default_rng(1)
    starts, parts, pos = [], [], 0
    for t in texts:
        starts.append(pos)
        parts.append(t + CODES[rng.integers(0, 4, gap)].tobytes().decode())
        pos += len(parts[-1])
    second = ([starts[(i + 1) % len(starts)] for i in range(len(starts))]
              if unrelated else [s + 1 for s in starts])
    locs = [[s] + ([second[i]] if i % 5 == 0 else [])
            for i, s in enumerate(starts)]
    return "".join(parts), locs


def reads(cls_read, cls_loc, queries, locs):
    return [cls_read(description=f"r{i}", content=q,
                     locations=[cls_loc(start_in_reference=s) for s in ls])
            for i, (q, ls) in enumerate(zip(queries, locs))]


def jax_cfg(W, K, O):
    return JaxAlignConfig(W=W, K=K, O=O, backend="xla", batch_tile=TILE)


def jax_reads(genome, queries, locs, W, K, O):
    return scrooge_tpu.align_all(JaxGenome(content=genome),
                                 reads(JaxRead, JaxLoc, queries, locs),
                                 config=jax_cfg(W, K, O))


def case(wko, lo, hi, rate=0.04, unrelated=True):
    """dict(wko, texts, queries, genome, locs, and the JAX package's
    alignments: want_pairs, want_reads); ``unrelated`` as in mapped."""
    W, K, O = wko
    texts, queries = seqs(np.random.default_rng(W), PAIRS, lo, hi, rate)
    genome, locs = mapped(texts, unrelated=unrelated)
    return dict(wko=wko, texts=texts, queries=queries, genome=genome,
                locs=locs,
                want_pairs=key(scrooge_tpu.align_all(
                    texts, queries, config=jax_cfg(W, K, O))),
                want_reads=key(jax_reads(genome, queries, locs, W, K, O)))


def port_calls(c, device, tile):
    """The port's align_pairs and align_reads on case ``c``, strings and
    packed, at batch_tile ``tile``: {(interface, mode): [(ed, cigar)]}."""
    W, K, O = c["wko"]
    cfg = st.AlignConfig(W=W, K=K, O=O, batch_tile=tile)
    genome = st.Genome(content=c["genome"])
    rs = reads(st.Read, st.CandidateLocation, c["queries"], c["locs"])
    out = {}
    for mode, packed in (("strings", False), ("packed", True)):
        a = st.align_pairs(c["texts"], c["queries"], cfg,
                           return_packed=packed, device=device)
        b = st.align_reads(genome, rs, cfg, return_packed=packed,
                           device=device)
        out["pairs", mode] = key(a.to_alignments() if packed else a)
        out["reads", mode] = key(b.to_alignments() if packed else b)
    return out


def check_tiles(c, device):
    """Four tiles and more: the JAX package's alignments, and the port's
    own in one tile; no thread outlives a call."""
    import threading

    want = {"pairs": c["want_pairs"], "reads": c["want_reads"]}
    before = threading.active_count()
    tiled = port_calls(c, device, TILE)
    assert threading.active_count() == before
    one = port_calls(c, device, 4 * TILE)
    for (interface, mode), got in tiled.items():
        assert got == want[interface], (interface, mode)
        assert one[interface, mode] == got, (interface, mode)
    assert sum(ed > 0 for ed, _ in want["pairs"]) > len(want["pairs"]) // 2
