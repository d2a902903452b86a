"""The port's multi-process layer (scrooge_tpu_torch/parallel/distributed.py)
on the CPU: the shard arithmetic against the JAX package's, a single
process against align_reads, and real 2-process gloo runs against the
JAX package's direct result. Every comparison is exact equality; a
worker that fails or outlives its time limit fails the test.
"""

import json
import os
import random
import socket
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scrooge_tpu  # noqa: E402
import scrooge_tpu_torch as st  # noqa: E402
from scrooge_tpu import AlignConfig as JaxAlignConfig  # noqa: E402
from scrooge_tpu import CandidateLocation as JaxLoc  # noqa: E402
from scrooge_tpu import Read as JaxRead  # noqa: E402
from scrooge_tpu.parallel import distributed as jax_dist  # noqa: E402
from scrooge_tpu.utils.simulate import (  # noqa: E402
    simulate_dataset as jax_simulate)
from scrooge_tpu_torch import AlignConfig, CandidateLocation, Read  # noqa: E402
from scrooge_tpu_torch.parallel import distributed as dist  # noqa: E402
from scrooge_tpu_torch.utils.simulate import simulate_dataset  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dist_worker.py")
CLUSTER_VARS = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK", "SLURM_PROCID", "SLURM_NTASKS",
                "SLURM_LOCALID", "SLURM_LAUNCH_NODE_IPADDR")


@pytest.fixture
def no_cluster(monkeypatch):
    for v in CLUSTER_VARS:
        monkeypatch.delenv(v, raising=False)


def _reads(n, seed=1):
    """Reads with one or two candidate locations, in both packages."""
    rng = random.Random(seed)
    port, jax_reads = [], []
    for i in range(n):
        content = "".join(rng.choice("ACGT") for _ in range(60))
        starts = [0] + ([4] if i % 3 == 0 else []) + (
            [9] if i % 7 == 0 else [])
        port.append(Read(description=f"r{i}", content=content,
                         locations=[CandidateLocation(start_in_reference=s)
                                    for s in starts]))
        jax_reads.append(JaxRead(description=f"r{i}", content=content,
                                 locations=[JaxLoc(start_in_reference=s)
                                            for s in starts]))
    return port, jax_reads


def _shape(reads):
    return [(r.description, r.content,
             [l.start_in_reference for l in r.locations]) for r in reads]


@pytest.mark.parametrize("count", range(1, 9))
def test_shard_reads_matches_jax_package(count):
    reads, jax_reads = _reads(29)
    total = sum(len(r.locations) for r in reads)
    seen = []
    for pid in range(count):
        got, idx = dist.shard_reads(reads, process_id=pid,
                                    process_count=count)
        want, jidx = jax_dist.shard_reads(jax_reads, process_id=pid,
                                          process_count=count)
        assert idx == jidx and _shape(got) == _shape(want)
        assert all(i % count == pid for i in idx)
        seen += idx
    assert sorted(seen) == list(range(total))


def test_shard_load_balance():
    reads, _ = _reads(100, seed=2)
    total = sum(len(r.locations) for r in reads)
    counts = [len(dist.shard_reads(reads, process_id=p,
                                   process_count=8)[1]) for p in range(8)]
    assert sum(counts) == total and max(counts) - min(counts) <= 1


def test_single_process_equals_align_reads(no_cluster):
    ds = simulate_dataset(genome_len=20_000, num_reads=24, read_len=300,
                          seed=17)
    cfg = AlignConfig(batch_tile=128)
    direct = st.align_reads(ds.genome, ds.reads, cfg, device="cpu")
    dist.initialize()  # no cluster environment: a no-op
    assert not torch.distributed.is_initialized()
    assert dist.process_info() == (0, 1)
    assert dist.align_reads_distributed(ds.genome, ds.reads, cfg,
                                        device="cpu") == direct
    local, idx = dist.align_reads_distributed(ds.genome, ds.reads, cfg,
                                              gather=False, device="cpu")
    assert local == direct and idx == list(range(len(direct)))
    assert dist.scratch_budget("cpu") is None
    dist.destroy()  # no process group: a no-op


def test_cluster_environment(no_cluster, monkeypatch):
    assert dist._cluster_env() is None
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        dist._cluster_env()
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        dist.initialize()  # a cluster node never runs single-process
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    assert dist._cluster_env() == ("env://", 2, 1)
    for v in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v)
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    with pytest.raises(ValueError, match="SLURM"):
        dist._cluster_env()
    monkeypatch.setenv("SLURM_LAUNCH_NODE_IPADDR", "10.0.0.2")
    assert dist._cluster_env() == ("tcp://10.0.0.2:29500", 4, 3)
    with pytest.raises(ValueError, match="world_size and rank"):
        dist.initialize(init_method="tcp://127.0.0.1:1", world_size=2)


def test_default_device(no_cluster, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dist.default_device()
    with pytest.raises(RuntimeError, match="is_available"):
        dist.align_reads_distributed(st.Genome(content="ACGT"), [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "6")
    assert dist.default_device() == torch.device("cuda", 2)
    monkeypatch.delenv("LOCAL_RANK")
    assert dist.default_device() == torch.device("cuda", 0)  # rank 0


def _run_workers(tmp_path, extra=()):
    """Two real gloo processes of tests/torch_dist_worker.py; their JSON
    outputs. Fails the test when a worker fails or outlives 240 s."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    for v in CLUSTER_VARS:
        env.pop(v, None)
    outs = [tmp_path / f"out{r}.json" for r in range(2)]
    logs = [open(tmp_path / f"err{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", str(port), str(outs[r]),
         *extra], env=env, stdout=subprocess.DEVNULL, stderr=logs[r])
        for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=240)
    except subprocess.TimeoutExpired:
        pytest.fail("a distributed worker outlived 240 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        errs = []
        for f in logs:
            f.seek(0)
            errs.append(f.read()[-2000:])
            f.close()
    assert all(p.returncode == 0 for p in procs), errs
    return [json.loads(o.read_text()) for o in outs]


def test_two_processes_equal_jax_direct(tmp_path):
    results = _run_workers(tmp_path)
    ds = jax_simulate(genome_len=20_000, num_reads=24, read_len=300,
                      seed=17)
    direct = scrooge_tpu.align_all(ds.genome, ds.reads, config=JaxAlignConfig(
        backend="xla", batch_tile=128))
    want = [[a.edit_distance, a.cigar] for a in direct]
    assert results[0] == want and results[1] == want


def test_a_failing_rank_makes_every_rank_raise(tmp_path):
    results = _run_workers(tmp_path, ("--fail-rank", "1"))
    assert results[1] == {
        "error": "AlignmentError: pair 3: no alignment (injected)"}
    assert results[0]["error"].startswith(
        "AlignmentError: rank 1 failed to align its shard: AlignmentError: "
        "pair 3")
