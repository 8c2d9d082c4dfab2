"""The traffic is made from the seed alone: the same seed gives the same
lines, and every seed the same multiset of sizes in its own
order, with its own content."""

import numpy as np
import pytest
import torch

from portbench import corpus, registry

BIG = 2 ** 31 + 12_345          # more than 32 signed bits hold
TRAIN = dict(registry.traffic("train_ragged_b256"), lines=64)


def test_train_lines_repeat_for_a_seed():
    a = corpus.train_lines(BIG, TRAIN, 95, "cpu")
    b = corpus.train_lines(BIG, TRAIN, 95, "cpu")
    assert torch.equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert a[2] == b[2]


def test_train_sizes_are_the_same_for_every_seed():
    a = corpus.train_lines(BIG, TRAIN, 95, "cpu")
    b = corpus.train_lines(7, TRAIN, 95, "cpu")
    assert sorted(a[1]) == sorted(b[1])
    assert not np.array_equal(a[1], b[1])
    assert a[2] != b[2]
    lo, hi = TRAIN["width_min"], TRAIN["width_max"]
    assert min(a[1]) == lo and max(a[1]) == hi
    # one glyph to a cell: the width fixes the number of characters
    for w, t in zip(a[1], a[2]):
        assert len(t) == (w - 2 * TRAIN["margin"]) // TRAIN["cell_cols"]
        assert 2 * len(t) + 1 <= 256
    x = a[0]
    for i, w in enumerate(a[1]):
        assert float(x[i, w:].abs().sum()) == 0.0
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0


@pytest.mark.parametrize("n", [95, 399])
def test_charset(n):
    cs = corpus.charset(n)
    assert len(cs) == len(set(cs)) == n and "\x00" not in cs
