"""The port's fill-lab plain version against the TPU lab kernel.

tools/kernel_lab.py is loaded from its path and its ``pallas_call`` runs in
interpret mode, with the same seed-0 inputs (1024 lanes) as the port's
``run_plain``: the lab's own m and n and the (m, n) cases of
``kernel_lab.MN_CASES``. The sums are integers, so the comparison is
exact.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from jax.experimental import pallas as pl  # noqa: E402

from scrooge_tpu_torch.tools import kernel_lab  # noqa: E402

LAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools", "kernel_lab.py")


@pytest.fixture(scope="module")
def jax_lab():
    spec = importlib.util.spec_from_file_location("_tpu_kernel_lab", LAB)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    return kernel_lab.lab_inputs(1024)


@pytest.mark.parametrize("mn", kernel_lab.MN_CASES,
                         ids=lambda mn: "m{}-n{}".format(*mn))
@pytest.mark.parametrize("variant", ["full", "nostore", "noff"])
def test_run_plain_matches_jax_lab_interpret(jax_lab, monkeypatch, variant,
                                             mn):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    m, n, pmi = kernel_lab.lab_inputs(1024, 0, *mn)
    want = int(jax_lab.run(variant, 2, m, n, pmi))
    got = kernel_lab.run_plain(variant, 2,
                               *kernel_lab.from_lab_layout(m, n, pmi))
    assert int(got.total) == want
    assert int(got.wed.sum()) * 2 == want
    lane_m = torch.from_numpy(m.reshape(-1)).to(torch.int32)
    if mn[1] == 0:
        # every column a start column: column 0 first hits at d = m
        assert torch.equal(got.wed, lane_m)
    elif variant == "noff" and mn[1] is not None:
        # a row above that reads as zeros gives every lane wed 1
        assert want == 2 * 1024 and bool((got.wed == 1).all())
    if mn == (None, None):
        # the random case spreads wed across lanes
        assert int(got.wed.max()) - int(got.wed.min()) > 30


def test_run_on_cpu_takes_plain_version(inputs):
    port = kernel_lab.from_lab_layout(*inputs)
    a = kernel_lab.run("nostore", 3, *port, device="cpu")
    b = kernel_lab.run_plain("nostore", 3, *port)
    assert int(a.total) == int(b.total) and torch.equal(a.wed, b.wed)
    with pytest.raises(ValueError):
        kernel_lab.run_plain("bogus", 1, *port)


def test_r_mismatches_compares_rows_to_wed(inputs):
    """R comes back in full only, and r_mismatches compares a lane's rows
    0..wed: a flipped bit there counts, one in a later row does not."""
    port = [t[:, :256] if t.dim() == 2 else t[:256]
            for t in kernel_lab.from_lab_layout(*inputs)]
    port = [t.contiguous() for t in port]
    assert kernel_lab.run_plain("nostore", 1, *port).R is None
    want = kernel_lab.run_plain("full", 1, *port)
    K, COLS = kernel_lab.K, kernel_lab.COLS
    assert want.R.shape == (K + 1, COLS, 256)
    lanes = torch.arange(256)
    wed = want.wed.long()
    # every lane of the lab's inputs hits: bit 63 of column 0 clears
    assert bool(((want.R[wed, 0, lanes] >> 63) & 1).eq(0).all())
    for row, counted in ((wed[5], 1), (wed[5] - 1, 1), (wed[5] + 1, 0)):
        got = want._replace(R=want.R.clone())
        got.R[row, 3, 5] ^= 1
        assert kernel_lab.r_mismatches(got, want) == counted


def test_layout_converter_joins_words():
    m, n, pmi = kernel_lab.lab_inputs(128, seed=3)
    _, _, joined = kernel_lab.from_lab_layout(m, n, pmi)
    lo = pmi[:, 0].reshape(64, -1).astype(np.uint64)
    hi = pmi[:, 1].reshape(64, -1).astype(np.uint64)
    np.testing.assert_array_equal(joined.numpy().view(np.uint64),
                                  lo | (hi << np.uint64(32)))


def test_entry_point_needs_a_card_unless_asked_for_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        kernel_lab.main(["full"])
    assert kernel_lab.main(["noff", "--device", "cpu", "--batch", "128"]) == 0
    assert "us/window" in capsys.readouterr().out
