"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up, all counted in ``setup_s`` (process start to the first timed
call): the CUDA context; the genome and the read sets drawn on the card
from the seed (``generate.py``); then the program's own set-up, the genome
packed and made resident (``prepare_genome`` and its device words), and
``warmup_calls`` untimed calls, the first of which loads the kernels and
native helpers from the checkout's build directory (compiling them in a
fresh checkout). The device's peak memory is counted from the program's
set-up on, not from the harness's data generation.

The window: one caller, closed loop. ``align_reads(prepared, reads, cfg,
return_stats=True)`` is called back to back on the traffic's read sets in
turn until ``--seconds`` have passed since the first call's start;
``aligns_per_s`` is the pairs answered over the wall time from the first
call's start to the last call's end. With ``--trace 1`` the first
``trace_calls`` calls run under torch.profiler and the line carries the
per-layer metrics (``metrics/``), read from those calls' AlignStats and
trace, instead of the end-to-end ones.

After the window: the device's peak memory is read, the process is checked
for JAX or the JAX package (a run that loaded either prints no result and
exits 3), the program's state is freed, and ``check.py`` compares the kept
answers with the plain reference: ``wrong_answers``, the kept answers
that differ from the reference's plus the pairs of the window with no
answer, has the limit 0. It is the last line on stderr and, with its
limit, the last key of the result line.
Without a card, or with fewer cards than the cell asks for, the run prints
no result and exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from portbench import cells  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "scrooge_tpu")
# compiler caches of torch and triton, at fixed paths in the checkout, so
# that a kernel built by either is built once a checkout (the program's
# own nvcc and g++ builds go to its fixed scrooge_tpu_torch/_build)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": ".portbench_cache/torch_extensions",
              "TRITON_CACHE_DIR": ".portbench_cache/triton"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_label() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def make_inputs(cell: cells.Cell, seed: int, device, mark):
    """The cell's genome and read sets, drawn on ``device`` from ``seed``;
    ``mark(part, start)`` records each part's time."""
    import torch

    from portbench import generate

    conf, traffic = cell.config, cell.traffic
    t = time.perf_counter()
    gen = generate.generator(seed, device)
    genome, gcodes = generate.make_genome(
        conf["genome"]["chromosome_lengths"], gen, device)
    mark("genome made", t)
    t = time.perf_counter()
    rd = conf["reads"]
    sets = [generate.make_reads(
        genome, gcodes, traffic["reads_per_call"], rd["length"],
        rd["accuracy"], rd["error_ratio_sub_ins_del"],
        traffic.get("decoys_per_read", 0.0), gen, prefix=f"s{k}r")
        for k in range(traffic["read_sets"])]
    del gcodes, gen
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    mark("reads made", t)
    return genome, sets


def check_sample(cell: cells.Cell, sets, seed: int):
    """The pair indices of each read set whose answers are checked."""
    import numpy as np

    from portbench import check

    rng = np.random.default_rng(seed % (1 << 64))
    per_set = max(1, cell.traffic["check_pairs"] // len(sets))
    return [check.sample(rs, per_set, rng) for rs in sets]


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START):
    """Run the cell; its result line as a dict, or None where the process
    holds a forbidden module after the window. ``device`` "cuda" runs on
    the cell's cards; "cpu" runs the program's plain version here."""
    import numpy as np
    import torch

    import scrooge_tpu_torch as st
    from portbench import check, roofline
    from portbench import trace as ptrace

    conf, traffic = cell.config, cell.traffic
    cfg = st.AlignConfig(**conf["aligner"])
    cuda = device == "cuda"
    devs = [f"cuda:{i}" for i in range(cell.chips)] if cuda else [device]
    target = devs[0] if len(devs) == 1 else devs
    parts = {}

    def sync():
        if cuda:
            for d in devs:
                torch.cuda.synchronize(d)

    def mark(name, t0):
        parts[name] = time.perf_counter() - t0
        log(f"# set-up: {name} {parts[name]:.3f} s")

    mark("interpreter, imports and card lookup", t_start)
    t = time.perf_counter()
    if cuda:
        for d in devs:
            torch.zeros(1, device=d)
    mark("device context", t)

    genome, sets = make_inputs(cell, seed, devs[0], mark)
    n_pairs = [len(rs.pairs) for rs in sets]
    log(f"# inputs: {len(genome.content)} bases, pairs a set {n_pairs}")
    if cuda:
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)

    t = time.perf_counter()
    prepared = st.prepare_genome(genome)
    for d in devs:
        prepared.device_words(d)
    sync()
    mark("genome packed and uploaded", t)
    packed = traffic.get("output", "strings") == "packed"

    def call(c):
        return st.align_reads(prepared, sets[c % len(sets)].reads, cfg,
                              return_stats=True, return_packed=packed,
                              device=target)

    for w in range(traffic["warmup_calls"]):
        t = time.perf_counter()
        call(w)
        mark(f"warm-up call {w + 1}", t)
    t = time.perf_counter()
    gc.collect()
    gc.freeze()
    idx = check_sample(cell, sets, seed)
    mark("garbage collection and check sample", t)
    kept = [[] for _ in sets]
    trace_calls = traffic["trace_calls"] if trace else 0
    total, traced = st.api.AlignStats(), st.api.AlignStats()
    walls, attempted, missing, error = [], 0, 0, None
    prof = record = None
    if trace_calls:
        from torch.profiler import ProfilerActivity, profile, record_function

        record = record_function
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()

    t_first = t_end = time.perf_counter()
    setup_s = t_first - t_start
    c = 0
    while True:
        k = c % len(sets)
        t0 = time.perf_counter()
        attempted += n_pairs[k]
        try:
            if c < trace_calls:
                with record(ptrace.CALL_SPAN):
                    out, stats = call(c)
                    sync()
            else:
                out, stats = call(c)
        except Exception:  # the run goes on to report it: not correct
            error = traceback.format_exc()
            missing += n_pairs[k]
            t_end = time.perf_counter()
            break
        t_end = time.perf_counter()
        walls.append(t_end - t0)
        missing += check.missing(out, n_pairs[k])
        kept[k].append(check.answers(out, idx[k]))
        total.add(stats)
        if c < trace_calls:
            traced.add(stats)
        del out
        c += 1
        if prof is not None and c == trace_calls:
            prof.__exit__(None, None, None)
        if t_end - t_first >= seconds:
            break
    if prof is not None and c < trace_calls:
        prof.__exit__(None, None, None)
    sync()
    wall = t_end - t_first
    peak = (max(torch.cuda.max_memory_allocated(d) for d in devs)
            if cuda else 0)

    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return None
    del prepared
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    log(f"# card: {card_label() if cuda else device}")
    log(f"# window: {c} calls, {wall:.3f} s, {attempted - missing} pairs "
        f"answered; call walls s: min {min(walls, default=0):.4f} median "
        f"{float(np.median(walls)) if walls else 0:.4f} max "
        f"{max(walls, default=0):.4f}")
    log(f"# call walls s: {' '.join(f'{w:.3f}' for w in walls)}")
    log(f"# stages over the window: {total.breakdown()}")
    if error:
        log(f"# a call raised:\n{error}")

    tr = None
    if trace_calls and c:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            tr = ptrace.reduce(path)
        finally:
            os.remove(path)

    t = time.perf_counter()
    refs = [check.align_reference(genome.content, rs, ix, cfg.W, cfg.K,
                                  cfg.O, cfg.early_termination)
            for rs, ix in zip(sets, idx)]
    mism = sum(check.mismatches(kept[k], refs[k]) for k in range(len(sets)))
    compared = sum(len(kept[k]) * len(idx[k]) for k in range(len(sets)))
    log(f"# reference: {sum(len(ix) for ix in idx)} pairs in "
        f"{time.perf_counter() - t:.3f} s")
    correct = error is None and mism == 0 and missing == 0

    if not trace:
        known = {"aligns_per_s": (attempted - missing) / wall,
                 "device_peak_gib": peak / 2 ** 30, "setup_s": setup_s}
        metrics = {m.name: {"value": known[m.name], "unit": m.unit}
                   for m in cell.end_to_end}
    else:
        sampled = [(rs, i) for rs, ix in zip(sets, idx) for i in ix]
        work = {f: float(np.mean(np.concatenate([getattr(r, f)
                                                 for r in refs])))
                for f in ("cells", "steps", "runs", "windows")}
        work["read_chars"] = float(np.mean(
            [len(rs.reads[int(rs.pairs[i][0])].content) for rs, i in sampled]))
        n_traced = min(c, trace_calls)
        ctx = SimpleNamespace(
            calls=n_traced, stats=traced, trace=tr, W=cfg.W, work=work,
            pairs_per_call=sum(n_pairs[k % len(sets)]
                               for k in range(n_traced)) / max(n_traced, 1))
        metrics = (cells.metric_values(cell.per_layer, ctx)
                   if tr is not None else {})
        if tr is not None:
            least, by = roofline.per_call(ctx)
            log(f"# bound: {least:.4f} ms a call, by {by}; work a pair "
                f"{json.dumps(work)}")
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(devs[0]) if cuda else device,
           "count": len(devs), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted,
              "failed": missing, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in tr.top_ops()],
                               "idle_gaps": [list(x) for x in tr.gaps]}
    wrong = mism + missing
    result["checks"] = {"wrong_answers": {"value": wrong, "limit": 0}}
    log(f"# set-up parts s: {json.dumps(parts)}; setup_s {setup_s:.3f}")
    log(f"check wrong_answers {wrong} limit 0 ({mism} of {compared} "
        f"sampled answers differ from the reference; {missing} of "
        f"{attempted} pairs have no answer)")
    return result


def main(argv=None, device: str = "cuda") -> int:
    """The command line. ``device`` other than "cuda" skips the look for
    a card and runs the program's plain version there (the tests)."""
    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.load(ROOT, args.workload)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, rel)

    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        log(f"no result: {args.workload} needs {cell.chips} CUDA device(s), "
            f"found {torch.cuda.device_count()}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
