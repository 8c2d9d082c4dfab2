"""PNG image I/O (port of clstm_tpu/io/png.py).

Reference: read_png/write_png in extras.{h,cc} (libpng, float grayscale;
≈L1-400, unverified). Images are float32 grayscale in [0, 1]. PIL is
imported inside the functions, so the rest of the port runs where pillow is
not installed.
"""

from __future__ import annotations

import numpy as np


def read_png(fname: str) -> np.ndarray:
    """Read an image file as float32 grayscale [h, w] in [0, 1]."""
    from PIL import Image

    with Image.open(fname) as im:
        g = im.convert("L")
        arr = np.asarray(g, dtype=np.float32) / 255.0
    return arr


def write_png(fname: str, img: np.ndarray) -> None:
    """Write a float [0, 1] (or uint8) grayscale array as PNG."""
    from PIL import Image

    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a, 0.0, 1.0)
        a = (a * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(a, mode="L").save(fname)
