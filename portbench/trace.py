"""Reduce a torch.profiler chrome trace of the traced calls to numbers.

The busy-time arithmetic is a copy of ``trace_shares`` in
scrooge_tpu_torch/profiling/pipeline.py at commit 00e5ff3: the device is
busy in the union of its kernel, copy and set intervals, on every stream,
within the traced window, and idle in the rest. The window runs from the
first ``portbench.call`` annotation's start to the last one's end. Beside
it: device time by kernel name, the operations that took most device time,
and the longest idle gaps, each named by the host operation that overlaps
it most (of equal overlaps, the shortest: the innermost).
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

CALL_SPAN = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
NO_HOST_OP = "host code outside any profiled op"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: Dict[str, float]            # device seconds by op name
    gaps: List[Tuple[str, float]]         # the longest idle gaps

    def kernel_s(self, part: str) -> float:
        """Device seconds of the operations whose name holds ``part``."""
        return sum(s for n, s in self.device_s.items() if part in n)

    def top_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.device_s.items(), key=lambda x: -x[1])[:k]


def _union(intervals, t0: float, t1: float):
    """Busy length and the merged intervals of ``intervals`` in [t0, t1]."""
    merged = []
    for a, b in sorted(intervals):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def reduce(path: str, n_gaps: int = 10) -> Trace:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    calls = [e for e in events if e.get("name") == CALL_SPAN
             and e.get("cat") == "user_annotation"]
    if not calls:
        raise ValueError(f"no {CALL_SPAN} annotation in the trace")
    t0 = min(float(e["ts"]) for e in calls)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in calls)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy, merged = _union(((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in dev), t0, t1)
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        a = max(float(e["ts"]), t0)
        b = min(float(e["ts"]) + float(e["dur"]), t1)
        if b > a:
            by_name[e["name"]] += (b - a) / 1e6
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    idle = sorted(((edges[k], edges[k + 1])
                   for k in range(0, len(edges), 2)
                   if edges[k + 1] > edges[k]), key=lambda g: g[0] - g[1])
    host = [e for e in events if e.get("cat") in HOST_CATS]
    hs = np.array([float(e["ts"]) for e in host])
    he = hs + np.array([float(e["dur"]) for e in host])
    gaps = []
    for a, b in idle[:n_gaps]:
        name = NO_HOST_OP
        if len(host):
            over = np.minimum(he, b) - np.maximum(hs, a)
            best = over.max()
            if best > 0:
                tie = np.flatnonzero(over >= best * 0.99)
                name = host[int(tie[np.argmin((he - hs)[tie])])]["name"]
        gaps.append((name, (b - a) / 1e6))
    return Trace((t1 - t0) / 1e6, busy / 1e6, dict(by_name), gaps)
