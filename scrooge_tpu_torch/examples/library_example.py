"""Minimal usage demo of the library interfaces, on a torch device.

Counterpart of the JAX package's examples/library_example.py (itself the
analogue of the reference's library_example.cu:11-98): the unstructured
string-pairs interface and the read-mapping interface, each on the
window engine of ``--device`` (the CUDA kernels on a card, the plain
torch engine on the CPU) and on the scalar oracle (``backend="pyref"``),
which must agree.

Run: python -m scrooge_tpu_torch.examples.library_example [--device cpu]
"""

import argparse
import sys

import scrooge_tpu_torch as st
from scrooge_tpu_torch import AlignConfig, CandidateLocation, Genome, Read

BACKENDS = ("auto", "pyref")  # the window engine on the device; the oracle


def string_pairs_example(backend: str, device: str):
    texts = ["AAAACCCCGGGGTTTT", "GATTACAGATTACA"]
    queries = ["CCCCGGGGTTTTAAAA", "GATTACAGATTACA"]
    cfg = AlignConfig(backend=backend, batch_tile=128)
    alignments = st.align_all(texts, queries, config=cfg, device=device)
    print(f"[{backend}] string pairs:")
    for q, a in zip(queries, alignments):
        print(f"  {q}: edit_distance={a.edit_distance} cigar={a.cigar}")
    return alignments


def read_mapping_example(backend: str, device: str):
    genome = Genome(content="AAAACCCCGGGGTTTT" * 4,
                    chromosome_starts={"chr1": 0})
    reads = [
        Read(description="read1", content="CCCCGGGGTTTTAAAA",
             locations=[CandidateLocation(read_description="read1",
                                          chromosome="chr1",
                                          start_in_reference=4)]),
        Read(description="read2", content="AAAACCCC",
             locations=[CandidateLocation(read_description="read2",
                                          chromosome="chr1",
                                          start_in_reference=0),
                        CandidateLocation(read_description="read2",
                                          chromosome="chr1",
                                          start_in_reference=16)]),
    ]
    cfg = AlignConfig(backend=backend, batch_tile=128)
    alignments = st.align_all(genome, reads, config=cfg, device=device)
    print(f"[{backend}] read mapping (one alignment per candidate):")
    idx = 0
    for read in reads:
        for loc in read.locations:
            a = alignments[idx]
            print(f"  {read.description}@{loc.start_in_reference}: "
                  f"edit_distance={a.edit_distance} cigar={a.cigar}")
            idx += 1
    return alignments


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; every visible card), cuda:N, "
                        "or cpu (the plain torch engine)")
    args = p.parse_args(argv)
    out = {b: (string_pairs_example(b, args.device),
               read_mapping_example(b, args.device)) for b in BACKENDS}
    if out["auto"] != out["pyref"]:
        print("the device engine and the oracle disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
