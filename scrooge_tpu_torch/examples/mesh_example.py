"""Multi-device alignment demo: pairs sharded over a mesh of devices.

Counterpart of the JAX package's examples/mesh_example.py. The reference
runs on one GPU (GPU_ID 0, genasm_gpu.cu:67); the port shards alignment
pairs over a mesh (scrooge_tpu_torch/parallel/mesh.py), a tuple of torch
devices that may repeat one. Two ways to use it:

 1. Automatic: ``device="cuda"`` with no index is every visible card, and
    ``align_all`` splits each tile among them; a list of devices is a
    mesh of its entries.
 2. Explicit: build a mesh and call the engine-level helper, here
    ``align_batch_on_mesh``, which returns each shard's lanes and result
    on its own device.

With ``--device cpu`` both run on CPU shards (the plain torch engine, a
thread a shard); ``--shards`` shards of ``--device`` make the explicit
mesh (on one card: shards on streams of their own).

Run: python -m scrooge_tpu_torch.examples.mesh_example [--device cpu]
"""

import argparse
import sys

import numpy as np
import torch

import scrooge_tpu_torch as st
from scrooge_tpu_torch import AlignConfig
from scrooge_tpu_torch.ops import pack
from scrooge_tpu_torch.parallel import make_mesh
from scrooge_tpu_torch.parallel.mesh import align_batch_on_mesh


def automatic_mesh(device: str):
    """align_all on every visible card (or on the one device named)."""
    rng = np.random.default_rng(0)
    n = 256
    texts, queries = [], []
    for _ in range(n):
        t = "".join(rng.choice(list("ACGT"), 160))
        q = "".join(c if rng.random() > 0.05 else "A" for c in t[:120])
        texts.append(t)
        queries.append(q)
    cfg = AlignConfig(batch_tile=256)
    alns = st.align_all(texts, queries, config=cfg, device=device)
    one = st.align_all(texts, queries, config=cfg, device="cpu")
    print(f"device={device!r}, {n} pairs -> mean edit distance "
          f"{sum(a.edit_distance for a in alns) / n:.1f}, "
          f"equal to the CPU's: {alns == one}")
    return alns == one


def explicit_mesh(device: str, shards: int):
    """Engine level: align_batch_on_mesh over ``shards`` shards of
    ``device``; each shard's result stays on its device."""
    mesh = make_mesh(devices=[device] * shards)
    cfg = AlignConfig(W=64, K=64, O=33)
    B, read_len, text_len = 512, 100, 140
    rng = np.random.default_rng(1)
    text = rng.integers(0, 4, (B, text_len), dtype=np.uint8)
    pattern = np.where(rng.random((B, read_len)) < 0.05,
                       rng.integers(0, 4, (B, read_len), dtype=np.uint8),
                       text[:, :read_len]).astype(np.uint8)
    shard_results = align_batch_on_mesh(
        cfg, cfg.max_windows(read_len), mesh,
        pack.pack_2bit(torch.from_numpy(text)),
        torch.full((B,), text_len, dtype=torch.int32),
        pack.pack_2bit(torch.from_numpy(pattern)),
        torch.full((B,), read_len, dtype=torch.int32))
    eds = np.zeros(B, np.int64)
    failed = 0
    for s in shard_results:
        eds[s.lanes] = s.result.edit_distance.cpu().numpy()
        failed += int((s.result.failed != 0).sum().item())
    print(f"engine on a mesh: {B} pairs in {len(mesh)} shards on "
          f"{[str(d) for d in mesh]}, lanes a shard "
          f"{[len(s.lanes) for s in shard_results]}, mean edit distance "
          f"{eds.mean():.1f}, failed lanes {failed}")
    return failed == 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (every visible card), cuda:N or cpu")
    p.add_argument("--shards", type=int, default=2,
                   help="shards of --device in the explicit mesh")
    args = p.parse_args(argv)
    ok = automatic_mesh(args.device)
    ok &= explicit_mesh("cuda:0" if args.device == "cuda" else args.device,
                        args.shards)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
