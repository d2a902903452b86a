"""The port's tile pipeline at W > 256 on the CPU against the JAX package.

As test_torch_pipeline.py, at W/K/O = 288/288/145 (five-word bitvectors:
the wide kernel's config on a card, the JAX package's XLA engine): both
interfaces over four tiles of 128, strings and packed, on ``"cpu"`` and on
``["cpu", "cpu"]``, equal to ``backend="xla"`` and to the port's call in
one tile. Its own file: the JAX package compiles its engine at this width
for each interface, and the plain engine fills a window's rows in
lockstep up to the batch's largest distance, so the reads stay short
(120..220 bases, about 1 % edits) and every candidate is near its read
(no unrelated second location).
"""

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from torch_pipeline_cases import DEVICES, case, check_tiles  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def wide_case():
    return case((288, 288, 145), 120, 220, rate=0.005, unrelated=False)


@pytest.mark.parametrize("dev", list(DEVICES))
def test_wide_tiles_equal_jax_and_one_tile(wide_case, dev):
    check_tiles(wide_case, DEVICES[dev])
