"""Text-line normalization (dewarping to fixed height).

Reference: ``INormalizer`` with ``NoNormalizer``, ``MeanNormalizer`` and
``CenterNormalizer`` in extras.{h,cc} (≈L1-400, unverified; empty mount —
SURVEY.md §0). The C++ CenterNormalizer is the ocropus line dewarper
re-implemented: measure() smooths the line image (2-D gaussian + a small
uniform-filter term), extracts a per-column vertical center curve, smooths
it, and estimates the ink spread (mean absolute deviation -> half-window
``r``); normalize() extracts the [center-r, center+r) strip per column and
rescales it — both axes by the same factor — to ``target_height``.

This host-side implementation uses scipy.ndimage (gaussian/uniform filters,
spline zoom), the same operators as the ocropy original, maximizing numeric
fidelity. Normalization runs per line at data-load time (variable [h, w]
shapes); the batched on-device variant for the hot inference path lives in
ops/ (future work; host normalize is not the training bottleneck).

Env-param names follow the reference (``dewarp`` selects the normalizer in
the CLIs; range/smooth parameters via norm_* attrs — low confidence on the
exact reference env names).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter, gaussian_filter1d, uniform_filter, zoom


class INormalizer:
    """Interface: measure(line) then normalize(line) -> [target_height, w'].

    After normalize(), ``self.scale`` holds the width scale factor
    (normalized columns per source column) so frame positions can be mapped
    back to source-image x coordinates (reference CharPrediction.x)."""

    target_height: int = 48

    def __init__(self, target_height: int = 48):
        self.target_height = int(target_height)
        self.scale: float = 1.0

    def measure(self, line: np.ndarray) -> None:
        raise NotImplementedError

    def normalize(self, line: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, line: np.ndarray) -> np.ndarray:
        self.measure(line)
        return self.normalize(line)


class NoNormalizer(INormalizer):
    """Scale to target height preserving aspect ratio; no dewarping."""

    def measure(self, line: np.ndarray) -> None:
        self.shape = line.shape

    def normalize(self, line: np.ndarray) -> np.ndarray:
        h, w = line.shape
        scale = self.target_height / h
        out = zoom(line.astype(np.float32), (scale, scale), order=1,
                   mode="constant", cval=0.0)
        self.scale = out.shape[1] / max(w, 1)
        return _fix_height(out, self.target_height)


class MeanNormalizer(INormalizer):
    """Shift so the global ink center of mass sits mid-height, then scale."""

    def measure(self, line: np.ndarray) -> None:
        h, w = line.shape
        s = line.sum()
        ys = np.arange(h, dtype=np.float64)
        self.center = float((line.sum(axis=1) * ys).sum() / max(s, 1e-6))
        self.shape = line.shape

    def normalize(self, line: np.ndarray) -> np.ndarray:
        h, w = line.shape
        shift = int(round(h / 2.0 - self.center))
        shifted = np.zeros_like(line, dtype=np.float32)
        src_lo, src_hi = max(0, -shift), min(h, h - shift)
        dst_lo = max(0, shift)
        shifted[dst_lo:dst_lo + (src_hi - src_lo)] = line[src_lo:src_hi]
        scale = self.target_height / h
        out = zoom(shifted, (scale, scale), order=1, mode="constant", cval=0.0)
        self.scale = out.shape[1] / max(w, 1)
        return _fix_height(out, self.target_height)


class CenterNormalizer(INormalizer):
    """Per-column center-curve dewarping (the ocropus/reference algorithm).

    params = (range, smoothness, extra) with the upstream defaults
    (4, 1.0, 0.3): smoothing sigmas are (h*0.5, h*smoothness) for the 2-D
    filter, h*extra for the 1-D center-curve filter, half-window
    r = int(1 + range * mad) where mad is the mean |y - center| over ink.
    """

    def __init__(self, target_height: int = 48,
                 params: tuple = (4, 1.0, 0.3)):
        super().__init__(target_height)
        self.range, self.smoothness, self.extra = params

    def measure(self, line: np.ndarray) -> None:
        h, w = line.shape
        line = line.astype(np.float32)
        smoothed = gaussian_filter(line, (h * 0.5, h * self.smoothness),
                                   mode="constant")
        smoothed = smoothed + 0.001 * uniform_filter(
            smoothed, (h * 0.5, w), mode="constant")
        self.shape = (h, w)
        a = np.argmax(smoothed, axis=0).astype(np.float64)
        a = gaussian_filter1d(a, h * self.extra)
        # The smoothed curve sits on exact integers wherever argmax is
        # locally constant; raw truncation would amplify 1e-14 float noise
        # into a full-pixel shift (and makes native/Python parity a coin
        # flip). The epsilon stabilizes the knife edge; it only matters
        # within 1e-6 px of an integer. Mirrored in native/clstm_io.cc.
        self.center = np.array(a + 1e-6, dtype=np.int64)
        deltas = np.abs(np.arange(h)[:, None] - self.center[None, :])
        ink = line != 0
        self.mad = float(deltas[ink].mean()) if ink.any() else h / 4.0
        self.r = int(1 + self.range * self.mad)

    def dewarp(self, img: np.ndarray, cval: float = 0.0) -> np.ndarray:
        assert img.shape == self.shape, (img.shape, self.shape)
        h, w = img.shape
        padded = np.vstack([np.full((h, w), cval, np.float32),
                            img.astype(np.float32),
                            np.full((h, w), cval, np.float32)])
        center = self.center + h
        r = self.r
        cols = [padded[center[i] - r:center[i] + r, i] for i in range(w)]
        return np.array(cols, dtype=np.float32).T  # [2r, w]

    def normalize(self, line: np.ndarray) -> np.ndarray:
        dewarped = self.dewarp(line)
        h, w = dewarped.shape
        scale = self.target_height / h
        out = zoom(dewarped, (scale, scale), order=1, mode="constant", cval=0.0)
        self.scale = out.shape[1] / max(w, 1)
        return _fix_height(out, self.target_height)


def _fix_height(img: np.ndarray, th: int) -> np.ndarray:
    """zoom() rounds sizes; pad/crop to exactly target_height rows."""
    h = img.shape[0]
    if h == th:
        return img
    if h > th:
        lo = (h - th) // 2
        return img[lo:lo + th]
    pad_lo = (th - h) // 2
    pad_hi = th - h - pad_lo
    return np.pad(img, ((pad_lo, pad_hi), (0, 0)))


def make_normalizer(kind: str = "center", target_height: int = 48) -> INormalizer:
    """Factory (reference make_CenterNormalizer / dewarp env selection)."""
    kind = (kind or "center").lower()
    if kind in ("center", "dewarp"):
        return CenterNormalizer(target_height)
    if kind in ("mean",):
        return MeanNormalizer(target_height)
    if kind in ("none", "no"):
        return NoNormalizer(target_height)
    raise ValueError(f"unknown normalizer: {kind!r}")
