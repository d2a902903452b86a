"""A fixture for the port's test modules that run its plain engine.

Import it into a test module (``from torch_threads import
one_intra_op_thread``); it is autouse, so it applies to every test of
that module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread while the module runs, restored after.
    The plain engine's row scans work on tensors large enough for torch
    to split each op over all its threads; under several test workers
    those threads outnumber the cores, and every op then waits on the
    others' spinning threads (several times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
