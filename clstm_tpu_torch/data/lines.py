"""Synthetic text-line image generator (port of clstm_tpu/data/lines.py).

The reference benchmarks on UW3-500 (run-uw3-500 downloads a tarball of
real scanned line images), which is unavailable offline. This renderer
produces comparable inputs: black-on-white text-line images with variable
fonts/sizes, baseline sine warp and pixel noise, so the CenterNormalizer has
real dewarping work to do and CTC training sees realistic variability. For
the same seed it renders the same images as the JAX package's. PIL is
imported inside the functions that draw, so the rest of the port loads
where pillow is not installed.
"""

from __future__ import annotations

import glob
import os
import string
from typing import Optional, Sequence

import numpy as np


def _find_fonts() -> list:
    cands = []
    for pat in (
        "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
        "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
        "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
    ):
        cands.extend(glob.glob(pat))
    if not cands:
        try:
            import matplotlib
            base = os.path.join(matplotlib.get_data_path(), "fonts/ttf")
            for name in ("DejaVuSans.ttf", "DejaVuSerif.ttf"):
                p = os.path.join(base, name)
                if os.path.exists(p):
                    cands.append(p)
        except ImportError:
            pass
    return cands


DEFAULT_CHARSET = string.ascii_letters + string.digits + " .,;:'\"!?-()"

# Codepoint ranges for a large multi-script alphabet (config-4-style
# Fraktur/Devanagari stand-in with the fonts available offline):
# Latin + digits + Latin-1 supplement + Latin Extended-A + Greek + Cyrillic.
LARGE_ALPHABET_RANGES = ((0x41, 0x5B), (0x61, 0x7B), (0x30, 0x3A),
                         (0xC0, 0x100), (0x100, 0x180),
                         (0x391, 0x3A2), (0x3A3, 0x3CA), (0x410, 0x450))


def renderable_charset(fontpath: str, ranges=LARGE_ALPHABET_RANGES,
                       size: int = 32, dedupe_glyphs: bool = True) -> str:
    """Letters/digits from ``ranges`` that the font actually renders.

    dedupe_glyphs=True keeps only the FIRST character per distinct
    rendered glyph bitmap. Multi-script alphabets share homoglyphs
    (Cyrillic а/е/о/р/с/х and many Greek/Cyrillic capitals render
    pixel-identically to Latin in DejaVu); leaving them in puts an
    unlearnable ambiguity floor under any glyph-recognition CER — the
    model cannot tell identical images apart (measured: the undeduped
    384-class config-4 stand-in plateaus ~10pp above the deduped one).
    """
    import unicodedata

    from PIL import ImageFont

    f = ImageFont.truetype(fontpath, size)
    out = []
    seen = set()
    for lo, hi in ranges:
        for cp in range(lo, hi):
            ch = chr(cp)
            if not (unicodedata.category(ch).startswith("L") or ch.isdigit()):
                continue
            m = f.getmask(ch)
            if m.size[0] == 0 or m.size[1] == 0:
                continue
            key = (m.size, bytes(m))
            if dedupe_glyphs:
                if key in seen:
                    continue
                seen.add(key)
            out.append(ch)
    return "".join(out)


class LineGenerator:
    """Deterministic synthetic line renderer.

    render(text) -> float32 [h, w] image in [0, 1], ink black (0.0) on
    white (1.0) — the same polarity as scanned line datasets.
    """

    def __init__(self, seed: int = 0, fontsize: tuple = (24, 40),
                 warp_amp: tuple = (0.0, 6.0), noise: float = 0.03,
                 charset: str = DEFAULT_CHARSET):
        self.rng = np.random.RandomState(seed)
        self.fonts = _find_fonts()
        self.fontsize = fontsize
        self.warp_amp = warp_amp
        self.noise = noise
        self.charset = charset

    def random_text(self, minlen: int = 10, maxlen: int = 40) -> str:
        """Uniform random characters (max-entropy; hardest case)."""
        n = int(self.rng.randint(minlen, maxlen + 1))
        chars = [self.charset[self.rng.randint(len(self.charset))] for _ in range(n)]
        s = "".join(chars).strip()
        return s if s else "x"

    # Pseudo-English generator: real line datasets (UW3) are natural text
    # whose character distribution is highly redundant; training difficulty
    # (and the reference's <1% CER bar) assumes that redundancy, not
    # max-entropy char soup.
    _ONSETS = ("b c d f g h j k l m n p r s t v w st th ch sh br tr "
               "gr pl cl").split()
    _VOWELS = "a e i o u ea ou ai ee".split()
    _CODAS = ("b d g k l m n p r s t x ng st nd nt rs ck").split()

    def random_word(self) -> str:
        syll = self.rng.randint(1, 4)
        out = []
        for _ in range(syll):
            out.append(self._ONSETS[self.rng.randint(len(self._ONSETS))])
            out.append(self._VOWELS[self.rng.randint(len(self._VOWELS))])
            if self.rng.rand() < 0.6:
                out.append(self._CODAS[self.rng.randint(len(self._CODAS))])
        w = "".join(out)
        if self.rng.rand() < 0.15:
            w = w.capitalize()
        return w

    def random_sentence(self, minwords: int = 3, maxwords: int = 8) -> str:
        n = int(self.rng.randint(minwords, maxwords + 1))
        words = [self.random_word() for _ in range(n)]
        s = " ".join(words)
        r = self.rng.rand()
        if r < 0.3:
            s += "."
        elif r < 0.4:
            s += ","
        return s

    def _font(self):
        from PIL import ImageFont

        size = int(self.rng.randint(self.fontsize[0], self.fontsize[1] + 1))
        if self.fonts:
            path = self.fonts[self.rng.randint(len(self.fonts))]
            return ImageFont.truetype(path, size)
        return ImageFont.load_default(size=size)

    def render(self, text: str) -> np.ndarray:
        from PIL import Image, ImageDraw

        font = self._font()
        # Measure.
        tmp = Image.new("L", (8, 8), 255)
        d = ImageDraw.Draw(tmp)
        bbox = d.textbbox((0, 0), text, font=font)
        tw = max(bbox[2] - bbox[0], 4)
        th = max(bbox[3] - bbox[1], 4)
        margin = 10
        W, H = tw + 2 * margin, th + 2 * margin
        im = Image.new("L", (W, H), 255)
        d = ImageDraw.Draw(im)
        d.text((margin - bbox[0], margin - bbox[1]), text, font=font, fill=0)
        img = np.asarray(im, np.float32) / 255.0

        # Baseline sine warp: shift each column vertically.
        amp = self.rng.uniform(*self.warp_amp)
        if amp > 0.1:
            phase = self.rng.uniform(0, 2 * np.pi)
            period = self.rng.uniform(0.5, 2.0) * W
            pad = int(np.ceil(amp)) + 1
            img = np.pad(img, ((pad, pad), (0, 0)), constant_values=1.0)
            out = np.empty_like(img)
            for x in range(W):
                shift = amp * np.sin(2 * np.pi * x / period + phase)
                s0 = int(np.floor(shift))
                frac = shift - s0
                col = img[:, x]
                rolled0 = np.roll(col, s0)
                rolled1 = np.roll(col, s0 + 1)
                out[:, x] = (1 - frac) * rolled0 + frac * rolled1
            img = out

        if self.noise > 0:
            img = img + self.rng.normal(0.0, self.noise, img.shape).astype(np.float32)
            img = np.clip(img, 0.0, 1.0)
        return img.astype(np.float32)


def make_dataset_dir(path: str, n: int, seed: int = 0,
                     gen: Optional[LineGenerator] = None,
                     texts: Optional[Sequence[str]] = None) -> str:
    """Write n synthetic lines as <path>/line_XXXX.png + .gt.txt siblings
    and a manifest file (the reference's training-set layout:
    clstmocrtrain manifest of PNG paths with .gt.txt transcripts).
    Returns the manifest path."""
    from clstm_tpu_torch.io.png import write_png

    os.makedirs(path, exist_ok=True)
    gen = gen or LineGenerator(seed=seed)
    names = []
    for i in range(n):
        text = texts[i] if texts is not None else gen.random_text()
        img = gen.render(text)
        base = os.path.join(path, f"line_{i:05d}")
        write_png(base + ".png", img)
        with open(base + ".gt.txt", "w", encoding="utf-8") as f:
            f.write(text + "\n")
        names.append(base + ".png")
    manifest = os.path.join(path, "manifest.txt")
    with open(manifest, "w") as f:
        f.write("\n".join(names) + "\n")
    return manifest
