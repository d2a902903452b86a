"""The control of a cell's check, read at the cell's own size.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed: the cell's inputs are drawn as a run draws them
(``run.make_inputs`` on the card, or with ``--device cpu`` here), its
check sample is drawn (``run.check_sample``), and the plain reference
aligns the sampled pairs twice, as the reference and as the control: the
same algorithm with insertion and deletion swapped in the traceback's
order of priority, which keeps every alignment optimal and changes its
CIGAR. One JSON line a seed: the control's wrong answers in one call
a read set, the smallest count a window of the control in the program's
place could read; the runs' own check reads 0 on a sound program.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import cells, check, reference, run


def read_control(cell: cells.Cell, seed: int, device: str) -> dict:
    genome, sets = run.make_inputs(cell, seed, device, lambda *_: None)
    idx = run.check_sample(cell, sets, seed)
    W, K, O, et = (cell.config["aligner"][x] for x in
                   ("W", "K", "O", "early_termination"))
    out = {"workload": cell.name, "seed": seed,
           "pairs": int(sum(len(ix) for ix in idx)),
           "control_wrong_answers": 0}
    t = time.perf_counter()
    for rs, ix in zip(sets, idx):
        ref = check.align_reference(genome.content, rs, ix, W, K, O, et)
        ctl = check.align_reference(genome.content, rs, ix, W, K, O, et,
                                    reference.CONTROL_PRIORITY)
        kept = [[None if e < 0 else (int(e), c)
                 for e, c in zip(ctl.eds.tolist(), ctl.cigars)]]
        out["control_wrong_answers"] += check.mismatches(kept, ref)
    out["seconds"] = time.perf_counter() - t
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Read a cell's control.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = cells.load(run.ROOT, args.workload)
    for seed in args.seeds:
        print(json.dumps(read_control(cell, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
