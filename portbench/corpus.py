"""The one generator of the benchmark's data: glyph lines made from a seed.

A glyph is a fixed random bitmap, 48 rows high (ink in rows 8-39), drawn
from the seed; a line is a random text over the glyphs, one glyph to a
cell of fixed width, with blank margins, so that a line's width fixes its
number of characters. Every seed gets the same multiset of line sizes, in
its own order, and its own glyphs, texts and noise: the work is the same
from seed to seed and the content is not.

The lines are prepared lines, built on the card in a few large calls: ink
1 on 0, [T, 48] frames, the form a line image takes once it is normalised.
A mix's JSON file holds the parameters; nothing here knows a mix by name.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch.Generator on ``device`` for one stream of draws of the run
    with ``seed`` (any whole number: it is folded to 63 bits with the
    stream's number)."""
    s = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream])
    return torch.Generator(device=device).manual_seed(
        int(s.generate_state(1, np.uint64)[0]) >> 1)


def charset(nglyphs: int) -> list:
    """The characters the classes 1..nglyphs stand for: the 95 printable
    ASCII characters where they suffice, else code points from U+0100."""
    if nglyphs <= 95:
        return [chr(32 + k) for k in range(nglyphs)]
    return [chr(0x100 + k) for k in range(nglyphs)]


def glyph_bank(gen: torch.Generator, nglyphs: int, cell: int,
               glyph_cols: tuple, device) -> torch.Tensor:
    """[nglyphs, cell, 48] glyph columns: each glyph's bitmap (density
    0.35, ink in rows 8-39) in the first 6-12 (``glyph_cols``) columns of
    its cell, the rest of the cell blank."""
    lo, hi = glyph_cols
    widths = torch.randint(lo, hi + 1, (nglyphs,), generator=gen,
                           device=device)
    bits = (torch.rand((nglyphs, cell, 48), generator=gen, device=device)
            < 0.35).float()
    bits[:, :, :8] = 0.0
    bits[:, :, 40:] = 0.0
    col = torch.arange(cell, device=device)
    return bits * (col[None, :] < widths[:, None]).float()[..., None]


def fixed_sizes(n: int, lo: int, hi: int) -> np.ndarray:
    """n sizes spread evenly over [lo, hi], the same for every seed."""
    return lo + (np.arange(n, dtype=np.int64) * (hi - lo)) // max(n - 1, 1)


def render(gen: torch.Generator, bank: torch.Tensor, widths: np.ndarray,
           cell: int, margin: int, noise: float, device):
    """Lines of the given widths (frames) over ``bank`` -> (x [n, Wmax, 48]
    f32 ink in [0, 1] on the card, zero past each width; texts [n] as
    class-id lists). Each line holds (width - 2·margin) // cell glyphs
    drawn from the seed; ``noise`` > 0 adds gaussian pixel noise inside the
    width, clipped to [0, 1]."""
    n, W = len(widths), int(widths.max())
    nglyphs = bank.shape[0]
    nchars = (widths - 2 * margin) // cell
    K = int(nchars.max())
    ids = torch.randint(1, nglyphs + 1, (n, K), generator=gen, device=device)
    w = torch.as_tensor(widths, device=device)[:, None]
    nc = torch.as_tensor(nchars, device=device)[:, None]
    t = torch.arange(W, device=device)[None, :]
    k = torch.div(t - margin, cell, rounding_mode="floor")
    ink = (t >= margin) & (k < nc)
    g = torch.gather(ids, 1, k.clamp(0, K - 1).expand(n, W)) - 1
    flat = bank.reshape(nglyphs * cell, 48)
    x = flat[(g * cell + (t - margin) % cell).reshape(-1)].reshape(n, W, 48)
    x = x * ink[..., None].float()
    if noise > 0:
        x = x + noise * torch.randn((n, W, 48), generator=gen, device=device)
        x = x.clamp_(0.0, 1.0)
    x = x * (t < w)[..., None].float()
    ids_host = ids.cpu().numpy()
    texts = [list(ids_host[i, :nchars[i]]) for i in range(n)]
    return x, texts


def train_lines(seed: int, mix: dict, nglyphs: int, device):
    """The training corpus of a mix: mix["lines"] prepared lines of widths
    spread over [width_min, width_max] frames in the seed's order ->
    (x [n, Wmax, 48] f32 on the card, widths [n] numpy, texts as class-id
    lists)."""
    widths = fixed_sizes(mix["lines"], mix["width_min"], mix["width_max"])
    order = torch.randperm(len(widths), generator=generator(seed, 1, "cpu"))
    widths = widths[order.numpy()]
    gen = generator(seed, 2, device)
    bank = glyph_bank(gen, nglyphs, mix["cell_cols"],
                      tuple(mix["glyph_cols"]), device)
    x, texts = render(gen, bank, widths, mix["cell_cols"], mix["margin"],
                      mix["noise"], device)
    return x, widths, texts
