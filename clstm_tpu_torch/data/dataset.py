"""Line preparation, width buckets and target-length buckets (port of part
of clstm_tpu/data/dataset.py).

Line preparation matches the ocropy/reference recipe (clstmhl.h ≈L120):
invert (ink high), measure+normalize, rescale to [0,1], transpose to
time-major, pad blank frames on both sides. Lines are grouped into the same
geometric width buckets as the JAX package, so both packages pad a page the
same way.
"""

from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np

from clstm_tpu_torch.io.normalize import INormalizer

# Geometric width buckets (frames, after padding); lines wider than the
# last bucket are truncated to it.
T_BUCKETS = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)
# Target-state buckets (S = 2N+1 CTC states, padded up): S up to 512 covers
# transcripts up to 255 characters.
S_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def prepare_line(img: np.ndarray, normalizer: INormalizer,
                 pad: int = 16) -> np.ndarray:
    """Grayscale [h, w] in [0,1], ink-black-on-white -> model input [T, H]."""
    inv = img.max() - img if img.size else img
    normalizer.measure(inv)
    strip = normalizer.normalize(inv)            # [target_height, w']
    m = strip.max()
    if m > 0:
        strip = strip / m
    x = strip.T.astype(np.float32)               # [w', H]
    if pad > 0:
        x = np.pad(x, ((pad, pad), (0, 0)))
    return x


def bucket_for(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value (last bucket if value exceeds all)."""
    i = bisect.bisect_left(buckets, value)
    return buckets[min(i, len(buckets) - 1)]
