"""Pairs in shards over devices (``mesh``) and over processes
(``distributed``); the port of scrooge_tpu/parallel."""

from .mesh import (  # noqa: F401
    align_batch_mapped_on_mesh,
    align_batch_on_mesh,
    make_mesh,
    resolve_device,
    resolve_mesh,
    shard_lanes,
)
