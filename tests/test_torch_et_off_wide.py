"""Early termination off at W > 256 (and W = 256), against the JAX package.

As tests/test_torch_et_off.py, at W/K/O = 256/64/129 (four words) and
320/64/161 (five: the wide kernel's width). Its own file: with ET off the
JAX package's XLA engine fills every row of the 32 windows its API runs
for 128 lanes, about 25 s of CPU at W = 256 and 60 s at W = 320.
"""

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from torch_et_off_cases import check_config  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401


@pytest.mark.parametrize("wko", [(256, 64, 129), (320, 64, 161)],
                         ids=lambda w: "-".join(map(str, w)))
def test_align_pairs_without_early_termination_match_jax(wko):
    check_config(*wko)
