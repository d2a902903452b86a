"""A copy of the benchmark with one tiny cell added by files alone.

``tiny_copy(dst)`` copies BENCHMARK.json and portbench/ into ``dst`` and
adds, without editing any copied file but BENCHMARK.json's lists: a
configuration (``tiny_w64``: W=64 K=64 O=33 on a 200 kbp genome, reads of
400 bp), a traffic mix (``tiny``: 12 reads a call, Poisson(1) decoys, every
pair checked) and a per-layer metric (``traced_calls``), and the cell
``tiny`` that uses them. The tests run it on the CPU, where the program
runs its plain version.
"""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "tiny"


def tiny_copy(dst: str) -> str:
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = os.path.join(dst, "portbench")
    with open(os.path.join(pb, "configs", "pbsim2_clr_w64.json")) as f:
        conf = json.load(f)
    conf["name"] = "tiny_w64"
    conf["genome"]["chromosome_lengths"] = [150_000, 50_000]
    conf["reads"]["length"] = 400
    with open(os.path.join(pb, "configs", "tiny_w64.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(pb, "traffic", "tiny.json"), "w") as f:
        json.dump({"reads_per_call": 12, "read_sets": 2,
                   "decoys_per_read": 1.0, "output": "strings",
                   "warmup_calls": 1, "trace_calls": 1,
                   "check_pairs": 200}, f)
    with open(os.path.join(pb, "metrics", "traced_calls.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.calls\n")
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "tiny_w64", "source": "test",
        "file": "portbench/configs/tiny_w64.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny_w64",
                               "traffic": "tiny", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({
        "name": "traced_calls", "unit": "calls", "better": "higher",
        "source": "program_span", "layer": "test", "moves": "aligns_per_s",
        "workloads": [CELL]})
    for m in bench["per_layer"]:
        m.setdefault("workloads", [])
        if CELL not in m["workloads"]:
            m["workloads"].append(CELL)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst
