"""The traffic is made from the seed alone: the same seed gives the same
lines, and every seed the same multiset of sizes in its own
order, with its own content."""

import hashlib

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


def _digest(lines) -> str:
    x, widths, texts = lines
    h = hashlib.sha256(x.numpy().tobytes())
    h.update(np.asarray(widths, np.int64).tobytes())
    h.update(repr([[int(c) for c in t] for t in texts]).encode())
    return h.hexdigest()


@pytest.mark.parametrize("seed, nglyphs, digest", [
    # The lines of 48 rows before the corpus took its height from the
    # configuration (the generator of the benchmark's first cells).
    (BIG, 95,
     "ace739d65b36a90fdec0b266b735faaaa63cc6e307cac960cd89fe90f62fe397"),
    (BIG, 399,
     "4e3a6fa38104d1d492b7c810057e8002cbd6b620ec97eb8ac4bf36363dd6e9b5"),
    (7, 95,
     "ac59c3a0c50048854adb2b7a9adaa3acfbbb7047fadb3b31e849322a593e797c"),
    (7, 399,
     "9d21106eb0112cf004acab89fb277a37bd536fa7ec3bf8ad8fa1b5c2ef480f31")])
def test_lines_of_48_rows_are_the_same_bit_for_bit(seed, nglyphs, digest):
    lines = corpus.train_lines(seed, TRAIN, nglyphs, "cpu")
    assert lines[0].shape[2] == 48
    assert _digest(lines) == digest
    assert _digest(corpus.train_lines(seed, TRAIN, nglyphs, "cpu",
                                      height=48)) == digest


def test_a_36_row_corpus_has_the_same_widths_and_texts():
    """At 36 rows (Tesseract's line height) a seed gives the lines of 48
    rows' widths and texts, ink in rows 6-29 (8-39 scaled) under the
    noise."""
    a = corpus.train_lines(BIG, TRAIN, 95, "cpu")
    b = corpus.train_lines(BIG, TRAIN, 95, "cpu", height=36)
    assert b[0].shape == a[0].shape[:2] + (36,)
    assert np.array_equal(a[1], b[1]) and a[2] == b[2]
    quiet = dict(TRAIN, noise=0.0)
    x = corpus.train_lines(BIG, quiet, 95, "cpu", height=36)[0]
    rows = x.abs().sum(dim=(0, 1))
    assert float(rows[:6].sum()) == 0.0 and float(rows[30:].sum()) == 0.0
    assert bool((rows[6:30] > 0).all())
