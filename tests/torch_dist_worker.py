"""Worker of the port's real multi-process gloo runs
(tests/test_torch_distributed.py).

Usage: python tests/torch_dist_worker.py <rank> <world> <port> <out_json>
           [--fail-rank R]

Each process builds the same deterministic dataset
(simulate_dataset(20_000, 24, 300, seed=17), the JAX test's), aligns its
round-robin pair shard on the CPU, gathers every rank's results and
writes [[edit_distance, cigar], ...] to <out_json>. With --fail-rank R,
rank R's align_reads raises AlignmentError, and every rank writes
{"error": "<type>: <message>"} of the error it raised instead.
"""

import json
import sys


def main():
    rank, world, port, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4])
    fail_rank = (int(sys.argv[sys.argv.index("--fail-rank") + 1])
                 if "--fail-rank" in sys.argv else None)
    import torch

    from scrooge_tpu_torch import AlignConfig, api
    from scrooge_tpu_torch.parallel import distributed as dist
    from scrooge_tpu_torch.utils.simulate import simulate_dataset

    torch.set_num_threads(1)
    dist.initialize(init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                    rank=rank, timeout_s=120)
    try:
        if rank == fail_rank:
            def refuse(*args, **kwargs):
                raise api.AlignmentError("pair 3: no alignment (injected)")

            api.align_reads = refuse
        ds = simulate_dataset(genome_len=20_000, num_reads=24, read_len=300,
                              seed=17)
        try:
            alns = dist.align_reads_distributed(
                ds.genome, ds.reads, AlignConfig(batch_tile=128),
                gather=True, device="cpu")
            out = [[a.edit_distance, a.cigar] for a in alns]
        except api.AlignmentError as e:
            out = {"error": f"{type(e).__name__}: {e}"}
        with open(out_path, "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy()


if __name__ == "__main__":
    main()
