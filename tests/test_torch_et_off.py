"""Early termination off in the port, on the CPU, against the JAX package.

``AlignConfig(early_termination=False)`` makes every window fill its DP
rows 0..K (the JAX engines' ``d_cond``, engine_xla.py:236-241); the first
row that hits stays the window's distance, so no output changes. The
port's ``align_pairs(..., device="cpu")`` (the plain engine) with ET off
must equal the JAX package's ``align_pairs`` with ``backend="xla"`` and
ET off, and the port with ET on, at W/K/O = 64/64/33, 64/16/33 and
128/128/65 (256/64/129 and 320/64/161 in test_torch_et_off_wide.py), on
pairs made with numpy from a seed: related pairs, an empty read and a
text that runs out before its read. At K = 16 an unrelated pair in the
same batch raises the same AlignmentError in both packages. The plain engine's counters: with
ET off a lane fills K+1 rows of each of its windows, with ET on no more,
and fewer for a lane whose windows all hit before K.
"""

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scrooge_tpu_torch as st  # noqa: E402
from scrooge_tpu_torch.ops import engine, pack  # noqa: E402
from scrooge_tpu_torch.utils.simulate import edge_pairs  # noqa: E402
from torch_et_off_cases import check_config  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401


@pytest.mark.parametrize("wko, unrelated", [
    ((64, 64, 33), False), ((64, 16, 33), True), ((128, 128, 65), False),
], ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else
    ("unrelated" if v else "related"))
def test_align_pairs_without_early_termination_match_jax(wko, unrelated):
    check_config(*wko, unrelated=unrelated)


@pytest.mark.parametrize("wko", [(64, 64, 33), (128, 32, 65)],
                         ids=lambda w: "-".join(map(str, w)))
def test_plain_cell_counters(wko):
    """work[0] (cells filled) and work[2] (one row's cells over the
    windows): with ET off work[0] = (K+1) work[2] for every lane, and
    work[2] does not change with ET; with ET on work[0] is no larger, and
    smaller for a lane all of whose windows hit before K (an exact copy
    hits in row 0). Where no lane fails, the windows do not depend on K,
    so work[0] / (K+1) with ET off agrees for two values of K."""
    W, K, O = wko
    B = 48
    text, tlen, pattern, plen = edge_pairs(W + K, B, 300, 280, W - O)
    tw = pack.pack_2bit(torch.from_numpy(text))
    base = torch.arange(B, dtype=torch.int64) * (tw.shape[1] * 16)
    args = (tw, base, torch.from_numpy(tlen),
            pack.pack_2bit(torch.from_numpy(pattern)),
            torch.from_numpy(plen))

    def run(k, et):
        cfg = st.AlignConfig(W=W, K=k, O=O, early_termination=et)
        return engine.align_windows(cfg, cfg.max_windows(280), *args)

    on, off = run(K, True), run(K, False)
    for name in ("edit_distance", "failed", "counts"):
        assert torch.equal(getattr(on, name), getattr(off, name))
    assert torch.equal(off.work[0], (K + 1) * off.work[2])
    assert torch.equal(on.work[1:], off.work[1:])
    assert bool((on.work[0] <= off.work[0]).all())
    exact = (on.failed == 0) & (on.edit_distance == 0) & (
        torch.from_numpy(plen) > 0)
    assert int(exact.sum()) >= 3
    assert torch.equal(on.work[0][exact], on.work[2][exact])
    assert bool((on.work[0][exact] < off.work[0][exact]).all())
    ok = on.failed == 0
    other = run(K + 7, False)
    assert torch.equal(other.failed[ok], on.failed[ok])
    assert torch.equal(other.work[0][ok] // (K + 8),
                       off.work[0][ok] // (K + 1))
