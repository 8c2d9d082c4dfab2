"""Error metrics (port of clstm_tpu/utils/metrics.py).

Reference: templated ``levenshtein`` in utils.h (≈L1-250, unverified) — the
CER metric the training CLI's test-set reports use.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two sequences (strings or lists)."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    b_arr = np.array(list(b))
    prev = np.arange(len(b) + 1, dtype=np.int64)
    ar = np.arange(len(b) + 1, dtype=np.int64)
    for i, ca in enumerate(a, start=1):
        cur = np.minimum(prev[:-1] + (b_arr != ca), prev[1:] + 1)
        cur = np.concatenate(([i], cur))
        # close the deletion chain cur[j] = min(cur[j], cur[j-1]+1) via a
        # prefix-min of (cur - j): cur[j] = min_{k<=j}(cur[k] + j - k).
        cur = np.minimum.accumulate(cur - ar) + ar
        prev = cur
    return int(prev[-1])


def cer(truth: str, pred: str) -> float:
    """Character error rate = levenshtein / len(truth); 0 if both empty."""
    if not truth:
        return 0.0 if not pred else 1.0
    return levenshtein(truth, pred) / len(truth)
