"""Find a cell's files by the names in BENCHMARK.json.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the configuration's file is the one its ``configs`` entry gives, the
mix is ``traffic/<traffic>.json`` and each per-layer metric is read by
``metrics/<name>.py`` (a ``read(ctx)`` that returns a number, or None where
the run has nothing for it to read). So a configuration, a mix or a metric
is added by adding its file and its entry, and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable  # per-layer metrics only; None for end-to-end ones


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load_reader(path: str) -> Callable:
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + os.path.basename(path)[:-3].replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(root: str, workload: str, here: str = HERE) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json, with its
    configuration, traffic and metric readers. Raises KeyError for a cell
    the file does not list, OSError for a missing file."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(here, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [Metric(m["name"], m["unit"], None) for m in bench["end_to_end"]
           if _applies(m, workload)]
    layer: List[Metric] = []
    for m in bench["per_layer"]:
        if _applies(m, workload):
            layer.append(Metric(m["name"], m["unit"], _load_reader(
                os.path.join(here, "metrics", m["name"] + ".py"))))
    return Cell(workload, int(cell["chips"]), config, traffic, e2e, layer)


def metric_values(metrics: List[Metric], ctx) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the metrics whose reader finds
    something to read in ``ctx``."""
    out = {}
    for m in metrics:
        v = m.read(ctx)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out
