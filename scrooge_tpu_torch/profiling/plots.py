"""Figures from the port's CSVs (the reference's scripts/plot.py role).

Port of scrooge_tpu/profiling/plots.py (:59-488), reading the CSVs of the
port's own harnesses, which keep the JAX file names and headers and add
what ran (``engine``, ``card``, ``cards``, ``shards``, ``processes``):

  throughput  — aligns/s vs W (and vs O, vs batch tile), an early
                termination on and an off series, each measured with its
                own setting (profiling/sweep.py device)
  accuracy    — per-pair affine-score distributions, device vs the
                baselines (sweep accuracy)
  roofline    — measured aligns/s against the H100 bound of
                profiling/model.py across W (sweep device; the JAX
                module drew a v5e model)
  asic        — area/power vs O for the four SENE/DENT layouts
                (profiling/model.py sweep)
  groundtruth — fraction of ground-truth (MAF) matched bases aligned
                correctly vs W (sweep groundtruth)
  baselines   — aligns/s bars, device engine vs first-party baselines
                (sweep baselines)
  representative — the W=64+ET config against the baselines, and the
                engine's W scaling
  scaling     — throughput and weak-scaling efficiency vs shards or
                processes (profiling/scaling.py), each series naming its
                card and how many cards it used
  pipeline    — stacked end-to-end stage breakdown per call and output
                mode (profiling/pipeline.py)

Not ported: ``kernel`` and ``tbcap``, whose sweep families (the Pallas
kernel's knobs, the traceback cap) the port does not have.

matplotlib is imported lazily: nothing else in the port needs it.

CLI: python -m scrooge_tpu_torch.profiling.plots <kind> --csv=... [--out=fig.png]
"""

from __future__ import annotations

import argparse
import csv
import sys
from collections import defaultdict
from typing import Dict, List


def _read_csv(path: str) -> List[Dict[str, str]]:
    with open(path) as f:
        return list(csv.DictReader(f))


def _bool(s: str) -> bool:
    return s in ("True", "true", "1")


def plot_throughput(csv_path: str, out: str, x_axis: str = "W"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _read_csv(csv_path)
    series: Dict[bool, Dict[float, float]] = defaultdict(dict)
    band: Dict[bool, Dict[float, tuple]] = defaultdict(dict)
    for r in rows:
        et = _bool(r["early termination"])
        x = float(r[x_axis])
        y = float(r["aligns/second"])
        if y >= series[et].get(x, 0.0):
            series[et][x] = y
            # min/max spread columns (3 independently synced sample
            # groups per row) when present: drawn as an error band
            lo = float(r.get("aligns/second min") or y)
            hi = float(r.get("aligns/second max") or y)
            band[et][x] = (lo, hi)

    fig, ax = plt.subplots(figsize=(6, 4))
    for et, pts in sorted(series.items()):
        xs = sorted(pts)
        line, = ax.plot(xs, [pts[x] for x in xs], marker="o",
                        label=f"early termination {'on' if et else 'off'}")
        ax.fill_between(xs, [band[et][x][0] for x in xs],
                        [band[et][x][1] for x in xs],
                        color=line.get_color(), alpha=0.2, linewidth=0)
    ax.set_xlabel(x_axis)
    ax.set_ylabel("aligns/second")
    ax.set_title(f"Throughput vs {x_axis}")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


def plot_accuracy(device_csv: str, exact_csv: str, out: str):
    """Score-distribution family: per-pair affine scores of the device
    engine across W against every baseline algorithm in the baselines
    CSV (one box per algorithm column value — the reference compares
    genasm vs each of its vendored baselines the same way)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dev = _read_csv(device_csv)
    base = _read_csv(exact_csv)
    by_w: Dict[int, List[int]] = defaultdict(list)
    for r in dev:
        by_w[int(r["W"])].append(int(r["score"]))
    by_alg: Dict[str, List[int]] = defaultdict(list)
    for r in base:
        by_alg[r.get("algorithm", "exact")].append(int(r["score"]))
    algs = sorted(by_alg, key=lambda a: (a != "exact", a))

    fig, ax = plt.subplots(figsize=(max(6, 0.8 * (len(algs) + len(by_w))),
                                    4))
    data = [by_alg[a] for a in algs] + [by_w[w] for w in sorted(by_w)]
    labels = algs + [f"W={w}" for w in sorted(by_w)]
    ax.boxplot(data, tick_labels=labels, showfliers=False)
    ax.set_ylabel("affine-gap score")
    ax.set_title("Score distributions: baselines vs device engine (by W)")
    ax.grid(alpha=0.3, axis="y")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


def plot_roofline(csv_path: str, out: str, read_len: int = 10_000,
                  error_rate: float = 0.05, int32_tops: float = None):
    """Measured kernel aligns/s (the ET rows of a device sweep) against
    the H100 bound of profiling/model.py at each W (K = W, O = W/2 + 1,
    the sweep's WO family), evaluated at the batch each row ran. The
    bound's INT32 rate is ``int32_tops`` (Tops/s), by default the H100
    SXM's (model.H100_SXM_INT32_OPS_PER_S)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .model import H100_SXM_INT32_OPS_PER_S, sol_estimate

    rate = int32_tops * 1e12 if int32_tops else H100_SXM_INT32_OPS_PER_S
    rows = _read_csv(csv_path)
    meas: Dict[int, float] = {}
    batches: Dict[int, int] = {}
    for r in rows:
        if _bool(r["early termination"]):
            w = int(float(r["W"]))
            if float(r["aligns/second"]) >= meas.get(w, 0.0):
                meas[w] = float(r["aligns/second"])
                batches[w] = int(float(r["batch"]))

    ws = sorted(meas)
    bound = [sol_estimate(w, w, min(w // 2 + 1, w - 1), read_len,
                          error_rate, batches[w],
                          rate)["aligns_per_second_bound"] for w in ws]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(ws, bound, "--",
            label=f"H100 bound ({rate / 1e12:.2f} INT32 Tops/s)")
    ax.plot(ws, [meas[w] for w in ws], marker="o", label="measured")
    ax.set_xlabel("W")
    ax.set_ylabel("aligns/second")
    ax.set_yscale("log")
    ax.set_title("Measured kernel throughput vs the H100 bound")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


def plot_asic(csv_path: str, out: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _read_csv(csv_path)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for sene in (False, True):
        for dent in (False, True):
            pts = [(int(r["O"]), float(r["area_mm2"]), float(r["power_W"]))
                   for r in rows
                   if _bool(r["SENE"]) == sene and _bool(r["DENT"]) == dent]
            if not pts:
                continue
            pts.sort()
            label = f"SENE={int(sene)} DENT={int(dent)}"
            axes[0].plot([p[0] for p in pts], [p[1] for p in pts],
                         label=label)
            axes[1].plot([p[0] for p in pts], [p[2] for p in pts],
                         label=label)
    axes[0].set_xlabel("O")
    axes[0].set_ylabel("area (mm^2)")
    axes[1].set_xlabel("O")
    axes[1].set_ylabel("power (W)")
    for ax in axes:
        ax.grid(alpha=0.3)
        ax.legend(fontsize=7)
    fig.suptitle("ASIC vault area/power vs overlap (W=64)")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


def plot_groundtruth(csv_path: str, out: str,
                     baselines_csv: str = None, x_axis: str = "W"):
    """Ground-truth accuracy family (plot.py:2724-2952): the fraction of
    PBSIM2-MAF matched bases each CIGAR reproduces, vs the window size W.
    Mean curve with a 5th-95th percentile band over pairs; when a
    groundtruth_baselines CSV is given, each baseline's mean fraction is
    drawn as a dashed reference line (the reference plots genasm against
    its vendored baselines on the same axis)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _read_csv(csv_path)
    by_w: Dict[int, List[float]] = defaultdict(list)
    for r in rows:
        by_w[int(float(r[x_axis]))].append(float(r["correct_fraction"]))
    ws = sorted(by_w)

    def pct(v, p):
        v = sorted(v)
        return v[min(len(v) - 1, int(p * len(v)))]

    means = [sum(by_w[w]) / len(by_w[w]) for w in ws]
    lo = [pct(by_w[w], 0.05) for w in ws]
    hi = [pct(by_w[w], 0.95) for w in ws]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.fill_between(ws, lo, hi, alpha=0.2, label="5th-95th pct")
    ax.plot(ws, means, marker="o", label="mean")
    if baselines_csv:
        by_alg: Dict[str, List[float]] = defaultdict(list)
        for r in _read_csv(baselines_csv):
            by_alg[r["algorithm"]].append(float(r["correct_fraction"]))
        for i, (alg, vals) in enumerate(sorted(by_alg.items())):
            ax.axhline(sum(vals) / len(vals), ls="--", lw=1,
                       color=f"C{i + 1}", label=alg)
    ax.set_xlabel(x_axis)
    ax.set_ylabel("fraction of ground-truth bases aligned correctly")
    ax.set_title("Accuracy vs ground truth")
    ax.set_ylim(min(lo + [0.9]), 1.001)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


def plot_baselines(csv_path: str, out: str):
    """Baseline-comparison family (plot.py:1272-1331 bar semantics):
    aligns/second of the device engine vs the first-party baseline
    aligners on one dataset (log scale — the gaps span orders of
    magnitude, as in the reference's CPU/GPU baseline bars)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _read_csv(csv_path)
    algs = [r["algorithm"] for r in rows]
    vals = [float(r["aligns/second"]) for r in rows]
    fig, ax = plt.subplots(figsize=(6, 4))
    bars = ax.bar(algs, vals,
                  color=["C0" if a.startswith("genasm") else "C1"
                         for a in algs])
    for b, v in zip(bars, vals):
        ax.annotate(f"{v:,.0f}", (b.get_x() + b.get_width() / 2, v),
                    ha="center", va="bottom", fontsize=7)
    ax.set_yscale("log")
    ax.set_ylabel("aligns/second")
    ax.set_title("Throughput vs baseline aligners")
    ax.grid(alpha=0.3, axis="y")
    plt.setp(ax.get_xticklabels(), rotation=20, ha="right")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


def plot_representative(wo_csv: str, baselines_csv: str, out: str,
                        rep_w: int = 64):
    """Representative-config summary (plot.py:1272-1331): one panel with
    the device engine at the representative config (W=64, ET on — the
    Scrooge-GPU representative selection) against every baseline, one
    with the device engine's own W scaling around it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    wo = _read_csv(wo_csv)
    base = _read_csv(baselines_csv)
    dev_by_w: Dict[int, float] = {}
    for r in wo:
        if _bool(r["early termination"]):
            w = int(float(r["W"]))
            dev_by_w[w] = max(dev_by_w.get(w, 0.0),
                              float(r["aligns/second"]))
    rep = dev_by_w.get(rep_w) or (max(dev_by_w.values()) if dev_by_w else 0)

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    algs = [r["algorithm"] for r in base if r["algorithm"] != "genasm_device"]
    vals = [float(r["aligns/second"]) for r in base
            if r["algorithm"] != "genasm_device"]
    axes[0].bar(algs + [f"device W={rep_w}"], vals + [rep],
                color=["C1"] * len(algs) + ["C0"])
    axes[0].set_yscale("log")
    axes[0].set_ylabel("aligns/second")
    axes[0].set_title("Representative config vs baselines")
    plt.setp(axes[0].get_xticklabels(), rotation=20, ha="right")
    ws = sorted(dev_by_w)
    axes[1].plot(ws, [dev_by_w[w] for w in ws], marker="o")
    if rep_w in dev_by_w:
        axes[1].plot([rep_w], [dev_by_w[rep_w]], "r*", ms=14,
                     label=f"representative W={rep_w}")
        axes[1].legend()
    axes[1].set_xlabel("W")
    axes[1].set_ylabel("aligns/second")
    axes[1].set_title("Device engine W scaling")
    for ax in axes:
        ax.grid(alpha=0.3, axis="y")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


def plot_scaling(csv_path: str, out: str):
    """Scaling family: aligns/s and weak-scaling efficiency vs shards
    (the mesh CSV's ``devices``) or processes (the --distributed CSV),
    from profiling/scaling.py (the reference's threads sweep,
    profile.py:104-122). Each series is one engine and card, and its
    label says how many distinct cards its largest run used: shards or
    processes on one card are not scaling over cards."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _read_csv(csv_path)
    x_col = "devices" if "devices" in rows[0] else "processes"
    series: Dict[str, List[Dict[str, str]]] = defaultdict(list)
    for r in rows:
        series[f"{r.get('engine', 'processes')} on {r['card']}"].append(r)

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for i, (name, rs) in enumerate(sorted(series.items())):
        rs = sorted(rs, key=lambda r: int(r[x_col]))
        xs = [int(r[x_col]) for r in rs]
        label = f"{name}, {max(int(r['cards']) for r in rs)} card(s)"
        axes[0].plot(xs, [float(r["aligns_per_second"]) for r in rs],
                     marker="o", color=f"C{i}", label=label)
        # each series gets its own linear reference, anchored at its
        # first point
        base = float(rs[0]["aligns_per_second"])
        axes[0].plot(xs, [base * x / xs[0] for x in xs], "--",
                     color=f"C{i}", alpha=0.4,
                     label="linear" if i == 0 else None)
        axes[1].plot(xs, [float(r["weak_scaling_efficiency"]) for r in rs],
                     marker="o", color=f"C{i}", label=label)
    for ax, ylab, title in ((axes[0], "aligns/second", "Throughput"),
                            (axes[1], "efficiency",
                             "Weak-scaling efficiency")):
        ax.set_xlabel("shards" if x_col == "devices" else "processes")
        ax.set_ylabel(ylab)
        ax.set_title(title)
        ax.legend(fontsize=7)
        ax.grid(alpha=0.3)
    axes[1].set_ylim(0, 1.1)
    axes[1].axhline(0.8, color="r", ls=":", alpha=0.6)
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


def plot_pipeline(csv_path: str, out: str):
    """End-to-end stage breakdown: one stacked horizontal bar per call
    and output mode from profiling/pipeline.py's CSV, with the wall clock
    marked. With more than one tile the stages overlap, so a bar can run
    past its wall mark."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _read_csv(csv_path)
    stages = [("prep_s", "prep (host)"), ("upload_s", "upload h2d"),
              ("core_s", "device core"), ("compact_s", "compact"),
              ("readback_s", "readback d2h"), ("format_s", "format")]
    colors = ["tab:gray", "tab:orange", "tab:green", "tab:olive",
              "tab:blue", "tab:purple"]

    fig, ax = plt.subplots(figsize=(8, 2.2 + 0.8 * len(rows)))
    for yi, r in enumerate(rows):
        left = 0.0
        for (col, lab), c in zip(stages, colors):
            v = float(r[col])
            ax.barh(yi, v, left=left, color=c,
                    label=lab if yi == 0 else None)
            left += v
        wall = float(r["wall_s"])
        ax.plot([wall, wall], [yi - 0.4, yi + 0.4], color="k", lw=1.5)
        ax.annotate(f"wall {wall:.2f}s "
                    f"({int(r['pairs']) / wall:,.0f} aligns/s)",
                    (wall, yi), textcoords="offset points",
                    xytext=(4, -4), fontsize=8)
    ax.set_yticks(range(len(rows)))
    ax.set_yticklabels([f"{r['mode']} ({r['tiles']} tiles)" for r in rows])
    r0 = rows[0]
    rate = lambda v: f"{float(v):,.0f} MB/s" if v else "not measured"
    ax.set_xlabel(f"seconds (h2d {rate(r0['h2d_mb_s'])}, d2h "
                  f"{rate(r0['d2h_mb_s'])}; the stages sum to more than "
                  "the wall where they overlap)")
    ax.set_title(f"End-to-end pipeline breakdown: {r0['pairs']} pairs x "
                 f"{r0['read_len']} bp, W={r0['W']}, {r0['card']}")
    ax.legend(loc="lower right", fontsize=8, ncol=3)
    ax.grid(alpha=0.3, axis="x")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    print(f"wrote {out}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("kind",
                   choices=["throughput", "accuracy", "roofline", "asic",
                            "groundtruth", "baselines", "representative",
                            "scaling", "pipeline"])
    p.add_argument("--csv", required=True,
                   help="input CSV (device CSV for accuracy)")
    p.add_argument("--exact_csv", help="exact-baseline CSV (accuracy only)")
    p.add_argument("--baselines_csv",
                   help="baselines CSV (representative only)")
    p.add_argument("--out", default="figure.png")
    p.add_argument("--x", default="W", help="x axis column (throughput)")
    p.add_argument("--read_len", type=int, default=10_000,
                   help="the sweep's read length (roofline)")
    p.add_argument("--int32_tops", type=float, default=None,
                   help="the bound's INT32 rate (roofline; default H100 SXM)")
    args = p.parse_args(argv)

    if args.kind == "throughput":
        plot_throughput(args.csv, args.out, args.x)
    elif args.kind == "accuracy":
        if not args.exact_csv:
            p.error("--exact_csv required for accuracy plots")
        plot_accuracy(args.csv, args.exact_csv, args.out)
    elif args.kind == "roofline":
        plot_roofline(args.csv, args.out, args.read_len,
                      int32_tops=args.int32_tops)
    elif args.kind == "groundtruth":
        plot_groundtruth(args.csv, args.out, args.baselines_csv, args.x)
    elif args.kind == "baselines":
        plot_baselines(args.csv, args.out)
    elif args.kind == "representative":
        if not args.baselines_csv:
            p.error("--baselines_csv required for representative plots")
        plot_representative(args.csv, args.baselines_csv, args.out)
    elif args.kind == "scaling":
        plot_scaling(args.csv, args.out)
    elif args.kind == "pipeline":
        plot_pipeline(args.csv, args.out)
    else:
        plot_asic(args.csv, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
