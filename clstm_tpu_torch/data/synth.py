"""Synthetic tasks (port of clstm_tpu/data/synth.py, numpy only).

1. ``delayed_sequence_batch`` — the reference test-lstm.cc task (SURVEY.md
   §4): one-hot symbol sequences whose target is the input delayed by k
   frames; a sanity check that the recurrent cell can carry state.
2. ``LineGenerator`` (data/lines.py) renders synthetic text-line images for
   the OCR path.
"""

from __future__ import annotations

import numpy as np


def delayed_sequence_batch(rng: np.random.RandomState, B: int, T: int,
                           nsymbols: int, delay: int = 1):
    """One-hot inputs [B, T, n]; targets = inputs shifted right by ``delay``
    (first ``delay`` target frames are symbol 0). Numpy arrays: the caller
    moves them to its device."""
    syms = rng.randint(1, nsymbols, size=(B, T))
    x = np.zeros((B, T, nsymbols), np.float32)
    y = np.zeros((B, T, nsymbols), np.float32)
    b_idx = np.arange(B)[:, None]
    t_idx = np.arange(T)[None, :]
    x[b_idx, t_idx, syms] = 1.0
    tgt = np.zeros((B, T), np.int64)
    tgt[:, delay:] = syms[:, :-delay] if delay > 0 else syms
    y[b_idx, t_idx, tgt] = 1.0
    lengths = np.full(B, T, np.int32)
    return {"x": x, "y": y, "lengths": lengths, "classes": tgt}
