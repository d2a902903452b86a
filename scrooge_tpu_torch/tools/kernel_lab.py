"""Kernel lab: the window kernel's DP fill alone, in three ablation variants.

Port of the TPU lab ``tools/kernel_lab.py`` (``run``, body ``fill_kernel``).
It splits a fill's time between its arithmetic, its R stores and the row
above:

  full     the fill with every cell stored to R
  nostore  no stores to R
  noff     the row above reads as zeros, and no stores to R

Fixed shape W=64 K=64 O=33; by default every lane has m=31 and n=W and
random pattern masks (``lab_inputs``; ``MN_CASES`` lists the other m and
n the tests use), every window the same inputs. The kernel is
``csrc/genasm_fill_lab.cu``: a group of threads a lane on a wavefront over
rows, the row above in registers and shuffles, nothing of it in device
memory. ``run_plain`` is its plain torch version.

    python -m scrooge_tpu_torch.tools.kernel_lab [variant ...] \\
        [--batch 2048] [--device cuda|cpu]

runs 64 windows of each variant on the card (and raises without one)
unless ``--device cpu`` asks for the plain version, and prints the time
per window.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..api import resolve_device
from ..ops import _cuda

W, K, O = 64, 64, 33
COLS = W - O + 1
LANE = 128
M_DEFAULT = 31  # a typical mid-stream window, as in the TPU lab
VARIANTS = ("full", "nostore", "noff")
NWIN = 64  # windows a timed run fills, as in the TPU lab
# (m, n) cases the kernel is held to, the lab's own (31, W) among them;
# None draws each lane's value from 0..W. n = 0 makes every column a
# start column (wed = m); mixed values spread wed across lanes.
MN_CASES = tuple((m, n) for m in (1, 31, 64) for n in (0, 40, W)) + (
    (None, None),)


class LabResult(NamedTuple):
    total: torch.Tensor  # () int64: nwin * sum over lanes of wed
    wed: torch.Tensor    # (B,) int32 per-lane window edit distance
    # (K+1, COLS, B) int64 in full, what the last window stored (rows
    # that r_mismatches does not compare are unspecified); else None
    R: Optional[torch.Tensor] = None


def lab_inputs(batch: int, seed: int = 0, m=M_DEFAULT, n=W):
    """The TPU lab's inputs in its own layout: m and n (S, 128) int32 and
    pmi (W, 2, S, 128) uint32, word 0 the low half, from
    ``np.random.default_rng(seed)``. ``m`` and ``n`` are each lane's
    value, or None for values drawn per lane from 0..W after pmi."""
    if batch % LANE:
        raise ValueError(f"batch={batch} must be a multiple of {LANE}")
    S = batch // LANE
    rng = np.random.default_rng(seed)
    pmi = rng.integers(0, 2**32, (W, 2, S, LANE), dtype=np.uint32)
    m, n = (rng.integers(0, W + 1, (S, LANE), dtype=np.int32) if v is None
            else np.full((S, LANE), v, np.int32) for v in (m, n))
    return m, n, pmi


def from_lab_layout(m: np.ndarray, n: np.ndarray, pmi: np.ndarray):
    """TPU lab layout -> the port's: m, n (B,) int32 and pmi (W, B) int64,
    one 64-bit word per column and lane."""
    words = np.asarray(pmi, np.uint32).astype(np.uint64)
    joined = (words[:, 0] | (words[:, 1] << np.uint64(32))).reshape(W, -1)
    return (torch.from_numpy(np.ascontiguousarray(m, np.int32).reshape(-1)),
            torch.from_numpy(np.ascontiguousarray(n, np.int32).reshape(-1)),
            torch.from_numpy(joined.view(np.int64).copy()))


def _check(variant, nwin, m, n, pmi):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    if nwin < 1:
        raise ValueError("nwin must be >= 1")
    B = int(m.shape[0])
    for name, t, dt, shape in (("m", m, torch.int32, (B,)),
                               ("n", n, torch.int32, (B,)),
                               ("pmi", pmi, torch.int64, (W, B))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dt} of shape {shape}")
        if t.device != m.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {m.device}")
    return B


def run(variant: str, nwin: int, m, n, pmi, device="cuda") -> LabResult:
    """``nwin`` windows of the fill on ``device``: CUDA tensors launch the
    kernel once, CPU tensors take ``run_plain``; there is no fallback."""
    dev = resolve_device(device)
    m, n, pmi = (t.to(dev).contiguous() for t in (m, n, pmi))
    if dev.type == "cpu":
        return run_plain(variant, nwin, m, n, pmi)
    return launch(_cuda.GENASM_FILL_LAB, variant, nwin, m, n, pmi)


def launch(kernel, variant: str, nwin: int, m, n, pmi) -> LabResult:
    """One launch of ``kernel`` (the fill-lab kernel, or a source variant
    of it) on the device of its inputs; R, in full, is its only scratch
    and comes back in the result."""
    B = _check(variant, nwin, m, n, pmi)
    dev = m.device
    R = torch.empty(((K + 1) * COLS * B) if variant == "full" else 1,
                    dtype=torch.int64, device=dev)
    wed = torch.empty(B, dtype=torch.int32, device=dev)
    acc = torch.empty(B, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        kernel.launch(VARIANTS.index(variant), int(nwin), m.data_ptr(),
                      n.data_ptr(), pmi.data_ptr(), B, R.data_ptr(),
                      wed.data_ptr(), acc.data_ptr(), stream)
    return LabResult(acc.sum(), wed, R.view(K + 1, COLS, B)
                     if variant == "full" else None)


def run_plain(variant: str, nwin: int, m, n, pmi) -> LabResult:
    """The plain torch version, on the device of its inputs. Every window
    has the same inputs, so one window is filled and its sum counted
    ``nwin`` times. Lanes step in lockstep until every lane has hit."""
    B = _check(variant, nwin, m, n, pmi)
    dev = m.device
    i64 = torch.int64
    s = (W - m).to(i64)
    n64 = n.to(i64)
    above = [torch.zeros(B, dtype=i64, device=dev)] * (W + 1)  # row d-1
    R = (torch.zeros((K + 1, COLS, B), dtype=i64, device=dev)
         if variant == "full" else None)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    wed = torch.zeros(B, dtype=i64, device=dev)
    for d in range(K + 1):
        sh = s + d
        ones_d = torch.where(sh >= 64, 0, torch.full_like(sh, -1)
                             << sh.clamp(0, 63))
        right = topright = torch.zeros(B, dtype=i64, device=dev)
        for i in range(W, -1, -1):
            top = above[i]
            mat = (right << 1) | pmi[min(i, W - 1)]
            if d > 0:
                mat = mat & (topright << 1) & (top << 1) & topright
            center = torch.where(i >= n64, ones_d, mat)
            if variant != "noff":
                above[i] = center
            if R is not None:
                R[d, min(i, COLS - 1)] = center
            topright, right = top, center
        hit = ~found & (((right >> 63) & 1) == 0)
        wed = torch.where(hit, d, wed)
        found = found | hit
        if bool(found.all()):
            break
    return LabResult(wed.sum() * nwin, wed.to(torch.int32), R)


def r_mismatches(got: LabResult, want: LabResult) -> int:
    """Words of R (full) in which ``got`` differs from ``want``, the plain
    version's result, in the rows both must store: rows 0..wed of a lane
    that hit (bit 63 of its column 0 clear at row wed), 0..K of a lane
    that never did. Rows past those are left to each version."""
    Rg, Rw = got.R.to(want.R.device), want.R
    B = Rw.shape[2]
    wed = want.wed.long().to(Rw.device)
    lanes = torch.arange(B, device=Rw.device)
    hit = ((Rw[wed, 0, lanes] >> 63) & 1) == 0
    last = torch.where(hit, wed, K)
    rows = torch.arange(K + 1, device=Rw.device)[:, None, None]
    return int(((Rg != Rw) & (rows <= last)).sum().item())


def _time_ms(fn, dev) -> float:
    if dev.type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def measure(variants, batch: int = 2048, device="cuda"):
    """Time NWIN windows of each variant at ``batch`` lanes after a
    warm-up call (CUDA events on the card, the host clock on the CPU).
    Returns one dict per variant: ms, us_per_window, and wed_sum, the sum
    over lanes of one window's wed."""
    dev = resolve_device(device)
    m, n, pmi = (t.to(dev) for t in from_lab_layout(*lab_inputs(batch)))
    rows = []
    for v in variants:
        run(v, NWIN, m, n, pmi, device=dev)  # build and warm up
        ms = _time_ms(lambda: run(v, NWIN, m, n, pmi, device=dev), dev)
        wed = run(v, 1, m, n, pmi, device=dev).wed
        rows.append(dict(variant=v, batch=batch, ms=ms,
                         us_per_window=ms / NWIN * 1e3,
                         wed_sum=int(wed.sum()),
                         mean_wed=float(wed.double().mean())))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu, plain torch version")
    for r in measure(args.variants, args.batch, dev):
        print(f"{r['variant']:8s}: {r['ms']:8.3f} ms for {NWIN} windows "
              f"x {args.batch} pairs -> {r['us_per_window']:8.1f} us/window, "
              f"mean wed {r['mean_wed']:.3f} ({where})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
