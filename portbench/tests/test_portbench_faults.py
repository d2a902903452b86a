"""The check fails a run whose timed path is broken, and the control.

Each test runs the tiny cell (portbench_tiny.py) in this process on the
CPU, skipping the look for a card, with a fault planted under the timed
calls, and sees ``correct`` come out false. The cell has one card, so
there is no exchange between cards to leave out. A sound run of the same
cell comes out true.
"""

import numpy as np
import pytest

import scrooge_tpu_torch as st
from portbench import cells, reference, run
from portbench.tests.portbench_tiny import CELL, tiny_copy
from scrooge_tpu_torch import api, native
from scrooge_tpu_torch.ops import compact


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = tiny_copy(str(tmp_path_factory.mktemp("bench")))
    return cells.load(root, CELL, here=f"{root}/portbench")


def _correct(cell):
    return run.run_cell(cell, 2147483771, 1.0, False, device="cpu")[
        "correct"]


def test_sound_run_is_correct(cell):
    assert _correct(cell) is True


def test_packed_output_is_checked(cell, monkeypatch):
    """A mix with ``output: packed`` is read from PackedAlignments."""
    monkeypatch.setitem(cell.traffic, "output", "packed")
    assert _correct(cell) is True
    real = st.align_reads

    def altered(*a, **k):
        out, stats = real(*a, **k)
        out.edit_distances[0] += 1
        return out, stats

    monkeypatch.setattr(st, "align_reads", altered)
    assert _correct(cell) is False


def test_stale_answers(cell, monkeypatch):
    """Each call returns the first call's answers: the state unchanged."""
    first = []
    real = st.align_reads

    def stale(*a, **k):
        out = real(*a, **k)
        first.append(out)
        return first[0]

    monkeypatch.setattr(st, "align_reads", stale)
    assert _correct(cell) is False


def test_half_the_batch_left_out(cell, monkeypatch):
    real = st.align_reads

    def half(*a, **k):
        out, stats = real(*a, **k)
        return out[: len(out) // 2], stats

    monkeypatch.setattr(st, "align_reads", half)
    assert _correct(cell) is False


def test_edit_distance_altered_where_produced(cell, monkeypatch):
    """The engine's edit distance of a tile's first lane is off by one."""
    real = compact.batch_meta

    def altered(res):
        meta = real(res).clone()
        meta[0, 0] += 1
        return meta

    monkeypatch.setattr(compact, "batch_meta", altered)
    assert _correct(cell) is False


def test_cigar_token_altered_where_produced(cell, monkeypatch):
    """The native decode lengthens the first run of a part's first pair."""
    real = native.format_tokens

    def altered(*a, **k):
        out = real(*a, **k)
        return ["1" + out[0]] + list(out[1:]) if len(out) else out

    monkeypatch.setattr(native, "format_tokens", altered)
    assert _correct(cell) is False


def test_control_is_not_correct(cell, monkeypatch):
    """The reference with I and D swapped in the traceback's priority, in
    the program's place: optimal alignments, other CIGARs."""
    W, K, O = (cell.config["aligner"][x] for x in "WKO")

    def control(prepared, reads, cfg, **k):
        g = prepared.reference.content
        texts, pats = [], []
        for r in reads:
            for loc in r.locations:
                s = loc.start_in_reference
                span = reference.max_windows(W, O, len(r.content)) * (W - O)
                texts.append(reference.encode(g[s : s + span + W]))
                pats.append(reference.encode(r.content))
        res = reference.align(texts, pats, W, K, O,
                              priority=reference.CONTROL_PRIORITY)
        out = [st.Alignment(cigar=c, edit_distance=int(e))
               for e, c in zip(res.eds, res.cigars)]
        return out, api.AlignStats(num_pairs=len(out))

    monkeypatch.setattr(st, "align_reads", control)
    assert _correct(cell) is False
