"""The plain reference against hand-worked alignments."""

import pytest

from portbench import reference

# (text, read, W, K, O, edit distance, CIGAR); worked by hand from the
# reference's rules: semiglobal (the text's end is free), traceback
# priority I > D > X > =, runs flushed a window of W - O characters
CASES = [
    ("AAAACCCCGGGGTTTT", "CCCCGGGGTTTTAAAA", 64, 64, 33, 8, "4D12=4I"),
    ("ACGTACGT", "ACGTACGT", 64, 64, 33, 0, "8="),
    ("ACGTACGT", "AGGTACGT", 64, 64, 33, 1, "1=1X6="),
    ("ACGTACGTTT", "ACGTTACGT", 64, 64, 33, 1, "3=1I5="),
    ("ACGTAAACGT", "ACGTACGT", 64, 64, 33, 2, "4=2D4="),
    ("ACGTACGT", "ACGTACGTGG", 64, 64, 33, 2, "8=2I"),
    # windows of W - O = 4 characters: runs are not merged across them
    ("ACGTACGTAC", "ACGTACGTAC", 8, 8, 4, 0, "4=4=2="),
    ("AC", "ACGTACGT", 8, 8, 4, 6, "4I2=2I"),
    ("ATCAGA", "TAC", 64, 64, 33, 2, "1I1=1I"),
]


@pytest.mark.parametrize("text,read,W,K,O,ed,cigar", CASES)
def test_hand_worked(text, read, W, K, O, ed, cigar):
    res = reference.align([reference.encode(text)],
                          [reference.encode(read)], W, K, O)
    assert (int(res.eds[0]), res.cigars[0]) == (ed, cigar)


def test_all_pairs_at_once_equal_one_at_a_time():
    texts = [reference.encode(t) for t, *_ in CASES[:6]]
    reads = [reference.encode(r) for _, r, *_ in CASES[:6]]
    res = reference.align(texts, reads, 64, 64, 33)
    assert [(int(e), c) for e, c in zip(res.eds, res.cigars)] == [
        (ed, cig) for *_, ed, cig in CASES[:6]]


def test_control_swaps_insertion_and_deletion():
    res = reference.align([reference.encode("ATCAGA")],
                          [reference.encode("TAC")], 64, 64, 33,
                          priority=reference.CONTROL_PRIORITY)
    assert (int(res.eds[0]), res.cigars[0]) == (2, "1D1=1I1=")


def test_beyond_k_is_unalignable():
    res = reference.align([reference.encode("AAAAAAAA")],
                          [reference.encode("CCCCCCCC")], 64, 2, 33)
    assert int(res.eds[0]) == -1 and res.cigars[0] is None
