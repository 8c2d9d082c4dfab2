"""On-device text-line preprocessing: batched normalize+prepare and
train-time augmentation (port of clstm_tpu/ops/preprocess.py).

``prepare_batch_device`` is the prepare_line pipeline of the host path
(io/normalize.py + data/dataset.py: invert -> dewarp to ``target_height``
-> [0,1] rescale -> transpose time-major -> blank-frame pad) as batched
tensor ops over a padded raw-image batch ``[B, Hmax, Wmax]`` with per-line
true (h, w), on the device the batch lives on. Every line maps straight to
a fixed ``[out_T, target_height]`` output plus a ``length``: dewarping and
zooming compose into one bilinear resample of the inverted raw image,
because strip extraction is integer row selection, dew[i, x] =
inv[center[x] - r + i, x].

The semantics are the JAX package's, line for line; three pieces of it only
avoid TPU gathers and are written here as the gathers they stand for: the
FFT phase-ramp column alignment (here aligned[y, x] =
inv_zeropad[(row_top[x] + y) mod n_fft, x]), the one-hot interpolation
matmuls (here two-tap lerps) and the static window stack of the reflected
smoothing (here a strided view). Gaussian and uniform filter sigmas depend
on each line's h, so kernels are built per line over a static tap range with
a per-line truncation mask, matching scipy's truncate=4.0 radius
int(4*sigma+0.5) and constant-mode zero padding.

Numerics: everything is float32, with TF32 off (utils/config.py
torch_device); divisions by a constant are divisions by a tensor, since
PyTorch's CUDA divide turns a Python-number divisor into a multiply by its
reciprocal, 1 ulp off. Two measures keep floor() of the smoothed center
curve agreeing with the host's float64 path: plateau columns bypass the
weighted sum (emitting the exact integer), and the host's own 1e-6 epsilon
covers the f32 noise elsewhere. Residual disagreements are rare and +-1 px.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from clstm_tpu_torch.utils.config import to_device

# u8 pixel -> float32 k/255, correctly rounded (numpy's f32 division).
# Indexed on the device in place of a divide: PyTorch's CUDA ``x / 255.0``
# multiplies by the reciprocal, 1 ulp off for 126 of the 256 values, and
# the center normalizer's argmax turns ulp-level pixel noise into +-1 px
# width changes.
U8_TABLE = np.arange(256, dtype=np.float32) / np.float32(255.0)
# Lines per prepare_batch_device call in prepare_images: the center
# normalizer builds a [W, W] f32 Toeplitz matrix per line for W <= 1536
# (~0.6 GB for 64 such lines, with its temporaries a few times that).
PREPARE_CHUNK = 64


@functools.lru_cache(maxsize=None)
def u8_table(device: torch.device) -> torch.Tensor:
    """U8_TABLE on ``device`` (uploaded once per device)."""
    return to_device(U8_TABLE, device)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _const(t: torch.Tensor, v) -> torch.Tensor:
    """A 0-dim float32 tensor holding ``v`` on ``t``'s device, so that a
    division by it is a true division on the card too (no host copy)."""
    return t.new_full((), v, dtype=torch.float32)


def _taps(R: int, device) -> torch.Tensor:
    return torch.arange(-R, R + 1, dtype=torch.float32, device=device)


def _truncated_gauss(off: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """exp(-0.5 (off/sigma)^2) where |off| <= int(4 sigma + 0.5), else 0.
    ``sigma`` [B] broadcasts over the trailing dims of ``off``."""
    s = sigma.reshape((-1,) + (1,) * off.dim())
    radius = torch.floor(4.0 * s + 0.5)
    g = torch.exp(-0.5 * (off / s) ** 2)
    return torch.where(off.abs() <= radius, g, 0.0)


def _gauss_norm(sigma: torch.Tensor, max_radius: int) -> torch.Tensor:
    """[B] sums of each truncated gaussian over its FULL support [-R, R]
    (scipy normalizes the whole kernel; constant-mode zero padding does no
    edge renormalization). R can exceed the image axis, so the sum runs
    over a static range bounded by ``max_radius`` >= any R."""
    return _truncated_gauss(_taps(max_radius, sigma.device), sigma).sum(-1)


def _gauss_matrix(n: int, sigma: torch.Tensor, max_radius: int):
    """[B, n, n] correlation matrices M with M[i, j] = k(j - i): M @ x is
    scipy correlate1d(x, k, mode="constant") on a zero-padded buffer."""
    idx = torch.arange(n, dtype=torch.float32, device=sigma.device)
    off = idx[None, :] - idx[:, None]
    sigma = torch.clamp(sigma, min=1e-6)
    g = _truncated_gauss(off, sigma)
    return g / _gauss_norm(sigma, max_radius)[:, None, None]


def _gauss_conv_x(img: torch.Tensor, sigma: torch.Tensor, max_radius: int):
    """Correlate the rows of each [H, W] line of ``img`` [B, H, W] with its
    own gaussian, constant mode: a per-line Toeplitz product up to W=1536,
    a grouped convolution above (where [B, W, W] matrices grow too big)."""
    B, H, W = img.shape
    if W <= 1536:
        return img @ _gauss_matrix(W, sigma, max_radius).transpose(1, 2)
    sigma = torch.clamp(sigma, min=1e-6)
    g = _truncated_gauss(_taps(max_radius, img.device), sigma)
    g = g / g.sum(-1, keepdim=True)
    out = torch.nn.functional.conv1d(img.transpose(0, 1), g[:, None, :],
                                     padding=max_radius, groups=B)
    return out.transpose(0, 1)


def _uniform_axis(x: torch.Tensor, size: torch.Tensor, axis: int):
    """scipy uniform_filter1d, constant mode, over a zero-padded buffer,
    along ``axis`` (1 or 2) of [B, H, W], each line with its own window
    ``size`` [B], centered with left radius size//2."""
    size = torch.clamp(size, min=1)
    B, n = x.shape[0], x.shape[axis]
    c = torch.cumsum(x, dim=axis)
    zero_shape = list(x.shape)
    zero_shape[axis] = 1
    c = torch.cat([x.new_zeros(zero_shape), c], dim=axis)  # c[i]: first i
    i = torch.arange(n, device=x.device)[None, :]
    lo_r = (size // 2)[:, None]
    hi = torch.clamp(i + (size[:, None] - lo_r - 1) + 1, 0, n)
    lo = torch.clamp(i - lo_r, 0, n)

    def take(idx):                                  # idx [B, n]
        if axis == 1:
            idx = idx[:, :, None].expand(B, n, x.shape[2])
        else:
            idx = idx[:, None, :].expand(B, x.shape[1], n)
        return torch.gather(c, axis, idx.long())

    return (take(hi) - take(lo)) / size.to(x.dtype)[:, None, None]


def _reflect_smooth(a: torch.Tensor, w: torch.Tensor, sigma: torch.Tensor,
                    max_radius: int):
    """gaussian_filter1d(a[b, :w[b]], sigma[b], mode='reflect') for each row
    of ``a`` [B, n], computed on the full buffer (entries >= w are garbage,
    callers mask)."""
    B, n = a.shape
    R = max_radius
    sigma = torch.clamp(sigma, min=1e-6)
    taps = _taps(R, a.device)
    kern = _truncated_gauss(taps, sigma)
    kern = kern / kern.sum(-1, keepdim=True)                 # [B, 2R+1]

    i = torch.arange(-R, n + R, device=a.device)[None, :]
    w = w.long()[:, None]
    p = torch.clamp(2 * w, min=1)
    m = torch.remainder(i, p)
    ext = torch.gather(a, 1, torch.where(m < w, m, p - 1 - m))  # [B, n+2R]
    windows = ext.unfold(1, n, 1)                   # [B, 2R+1, n]: ext[j+t]
    out = (kern[:, None, :] @ windows)[:, 0]
    # Plateau shortcut: where every tap inside the radius holds the same
    # value, the exact answer is that value — emit it instead of the f32
    # weighted sum, whose noise would flip the downstream floor() on exactly
    # these integer-valued argmax-plateau columns (host/device parity).
    radius = torch.floor(4.0 * sigma + 0.5)
    inside = (taps.abs()[None, :] <= radius[:, None])[:, :, None]
    lo = torch.where(inside, windows, float("inf")).amin(1)
    hi = torch.where(inside, windows, -float("inf")).amax(1)
    return torch.where(lo == hi, windows[:, R], out)


def _lerp_taps(n_out: int, f: torch.Tensor, n_in: torch.Tensor,
               offset: int = 0):
    """The endpoint-aligned order-1 zoom as two taps per output row: row i
    reads (1 - frac) at floor((i - offset) * f) and frac at
    min(floor + 1, n_in - 1), per line (``f``, ``n_in`` [B]) -> (i0, i1,
    frac), each [B, n_out]."""
    i = torch.clamp(torch.arange(n_out, dtype=torch.float32,
                                 device=f.device) - offset, min=0.0)
    s = i[None, :] * f[:, None]
    i0 = torch.floor(s).to(torch.int32)
    i1 = torch.minimum(i0 + 1, torch.clamp(n_in - 1, min=0)[:, None])
    return i0, i1, s - i0.to(torch.float32)


def _prepare(img, h, w, *, kind: str, th: int, out_T: int, pad: int,
             params=(4.0, 1.0, 0.3)):
    """Raw [B, Hmax, Wmax] grayscale lines (ink black on white, [0,1]) with
    true sizes h, w [B] -> (x [B, out_T, th], lengths [B]). Mirrors
    data/dataset.py prepare_line."""
    B, Hmax, Wmax = img.shape
    dev = img.device
    iy = torch.arange(Hmax, device=dev)[None, :, None]
    ix = torch.arange(Wmax, device=dev)[None, None, :]
    valid = (iy < h[:, None, None]) & (ix < w[:, None, None])
    zero = img.new_zeros(())

    mx = torch.where(valid, img, zero).amax(dim=(1, 2))
    inv = torch.where(valid, mx[:, None, None] - img, zero)
    hf = h.to(torch.float32)

    rng, smooth, extra = params
    if kind == "center":
        # measure(): 2-D gaussian (constant mode) + 0.001*uniform term.
        sm = _gauss_matrix(Hmax, hf * 0.5, 2 * Hmax) @ inv
        sm = _gauss_conv_x(sm, hf * smooth, int(4 * smooth * Hmax + 0.5))
        sm = torch.where(valid, sm, zero)
        un = _uniform_axis(_uniform_axis(sm, h // 2, 1), w, 2)
        sm = sm + 0.001 * un
        a = torch.argmax(torch.where(iy < h[:, None, None], sm,
                                     -float("inf")), dim=1)        # [B, Wmax]
        a = _reflect_smooth(a.to(torch.float32), w, hf * extra,
                            int(4 * extra * Hmax + 1.5))
        # The host's 1e-6 epsilon (io/normalize.py measure): plateau
        # columns are exact integers, f32 noise elsewhere is ~3e-6.
        center = torch.floor(a + 1e-6).to(torch.int32)
        ink = (inv != 0) & valid
        deltas = (iy.to(torch.float32) - center[:, None, :]).abs()
        cnt = ink.sum(dim=(1, 2))
        mad = torch.where(
            cnt > 0,
            torch.where(ink, deltas, zero).sum(dim=(1, 2))
            / torch.clamp(cnt, min=1), hf / 4.0)
        r = (1.0 + rng * mad).to(torch.int32)
        # The alignment wraps circularly with period n_fft; rows outside
        # [0, h) must land in the zero padding, which bounds r <= n_fft -
        # Hmax (only pathological inputs hit this clamp).
        n_fft = _next_pow2(4 * Hmax)
        r = torch.clamp(r, max=n_fft - Hmax - 1)
        r2 = 2 * r
        row_top = center - r[:, None]
    elif kind == "mean":
        s = inv.sum(dim=(1, 2))
        cm = ((inv * iy.to(torch.float32)).sum(dim=(1, 2))
              / torch.clamp(s, min=1e-6))
        shift = torch.floor(hf / 2.0 - cm + 0.5).to(torch.int32)
        n_fft = _next_pow2(4 * Hmax)
        r2 = h
        # shifted[y] = inv[y - shift]; strip == shifted rows [0, h)
        row_top = (-shift)[:, None].expand(B, Wmax)
    elif kind == "none":
        n_fft = _next_pow2(2 * Hmax)
        r2 = h
        row_top = torch.zeros((B, Wmax), dtype=torch.int32, device=dev)
    else:
        raise ValueError(f"unknown normalizer kind: {kind!r}")

    r2f = r2.to(torch.float32)
    wf = w.to(torch.float32)
    scale = _const(r2f, th) / r2f
    out_w = torch.clamp(torch.floor(wf * scale + 0.5).to(torch.int32), 1,
                        out_T - 2 * pad)
    # Endpoint-aligned order-1 zoom (scipy grid_mode=False): oh rounds to
    # exactly th, so fix_height is a no-op here.
    fy = ((r2f - 1.0) / _const(r2f, th - 1) if th > 1
          else torch.zeros_like(r2f))
    fx = torch.where(out_w > 1,
                     (wf - 1.0) / torch.clamp(out_w - 1, min=1).to(
                         torch.float32), torch.zeros_like(wf))

    # The resample: rows (y) of the column-aligned strip, then columns (x).
    y0, y1, fyf = _lerp_taps(th, fy, r2)
    x0, x1, fxf = _lerp_taps(out_T, fx, w, offset=pad)

    def aligned_rows(y):
        """aligned[b, y, x] = inv_zeropad[(row_top + y) mod n_fft, x]
        for y < n_fft, 0 past it -> [B, th, Wmax]."""
        src = torch.remainder(row_top[:, None, :] + y[:, :, None], n_fft)
        ok = (src < Hmax) & (y[:, :, None] < n_fft)
        v = torch.gather(inv, 1, torch.clamp(src, max=Hmax - 1).long())
        return torch.where(ok, v, zero)

    rows = ((1.0 - fyf)[:, :, None] * aligned_rows(y0)
            + fyf[:, :, None] * aligned_rows(y1))             # [B, th, Wmax]

    def columns(x):
        idx = torch.clamp(x, 0, Wmax - 1).long()[:, None, :]
        return torch.gather(rows, 2, idx.expand(B, th, out_T))

    strip = ((1.0 - fxf)[:, None, :] * columns(x0)
             + fxf[:, None, :] * columns(x1)).transpose(1, 2)  # [B, out_T, th]

    t_img = torch.arange(out_T, device=dev)[None, :] - pad
    tvalid = ((t_img >= 0) & (t_img < out_w[:, None]))[:, :, None]
    strip = torch.where(tvalid, strip, zero)
    m = strip.amax(dim=(1, 2))
    x = strip / torch.where(m > 0, m, torch.ones_like(m))[:, None, None]
    length = torch.clamp(out_w + 2 * pad, max=out_T)
    return x.contiguous(), length.to(torch.int32)


def prepare_batch_device(imgs: torch.Tensor, hs: torch.Tensor,
                         ws: torch.Tensor, *, kind: str = "center",
                         target_height: int = 48, out_T: int = 1024,
                         pad: int = 16):
    """Batched on-device prepare_line.

    imgs: [B, Hmax, Wmax] raw grayscale lines, ink black on white,
    zero-padded to the buffer — float32 in [0, 1], or uint8 (k/255 looked
    up in U8_TABLE on the device; see pack_raw_images' 8-bit path); hs/ws:
    [B] integer true sizes, on the same device. Returns (x [B, out_T,
    target_height] float32, lengths [B] int32) ready for apply_net. Nothing
    here waits for the device.
    """
    if imgs.dim() != 3:
        raise ValueError(f"imgs must be [B, Hmax, Wmax], got "
                         f"{tuple(imgs.shape)}")
    if imgs.dtype == torch.uint8:
        imgs = u8_table(imgs.device)[imgs.long()]
    elif imgs.dtype != torch.float32:
        raise ValueError(f"imgs must be uint8 or float32, got {imgs.dtype}")
    for name, v in (("hs", hs), ("ws", ws)):
        if v.shape != imgs.shape[:1] or v.device != imgs.device:
            raise ValueError(f"{name} must be [{imgs.shape[0]}] on "
                             f"{imgs.device}, got {tuple(v.shape)} on "
                             f"{v.device}")
    return _prepare(imgs, hs.to(torch.int32), ws.to(torch.int32), kind=kind,
                    th=target_height, out_T=out_T, pad=pad)


def prepare_images(images, device, *, kind: str = "center",
                   target_height: int = 48, out_T: int = 1024, pad: int = 16,
                   chunk_size: int = PREPARE_CHUNK):
    """Raw line images (numpy [h, w] each) -> (x [B, out_T, target_height],
    lengths [B]) on ``device``: ``chunk_size`` lines at a time are packed at
    their own size (pack_raw_images), uploaded through pinned memory and
    prepared (prepare_batch_device). Nothing here waits for the device."""
    xs, lens = [], []
    for lo in range(0, len(images), chunk_size):
        buf, hs, ws = pack_raw_images(images[lo:lo + chunk_size])
        x, lengths = prepare_batch_device(
            to_device(buf, device), to_device(hs, device),
            to_device(ws, device), kind=kind, target_height=target_height,
            out_T=out_T, pad=pad)
        xs.append(x)
        lens.append(lengths)
    if len(xs) == 1:
        return xs[0], lens[0]
    return torch.cat(xs), torch.cat(lens)


def pack_raw_images(images) -> tuple:
    """Host helper: pad a list of [h, w] numpy grayscale images into the
    ([B, Hmax, Wmax], hs, ws) numpy buffers prepare_batch_device expects.

    8-bit path: when every pixel is exactly k/255 (always true for
    PNG-decoded lines), the buffer is returned as uint8, a quarter of the
    bytes to upload, and converted back to k/255 on the device, bit-equal
    to the float path; other images keep float32."""
    B = len(images)
    Hmax = max(int(im.shape[0]) for im in images)
    Wmax = max(int(im.shape[1]) for im in images)
    buf = np.zeros((B, Hmax, Wmax), np.float32)
    hs = np.zeros(B, np.int32)
    ws = np.zeros(B, np.int32)
    for i, im in enumerate(images):
        h, w = im.shape
        buf[i, :h, :w] = im
        hs[i] = h
        ws[i] = w
    return as_u8_if_exact(buf), hs, ws


def as_u8_if_exact(buf: np.ndarray) -> np.ndarray:
    """``buf`` as uint8 if every value is exactly k/255, else unchanged."""
    q = np.rint(buf * 255.0)
    if q.max(initial=0.0) <= 255.0 and np.array_equal(
            q.astype(np.float32) / np.float32(255.0), buf):
        return q.astype(np.uint8)
    return buf


def estimate_out_T(images, target_height: int, pad: int = 16) -> int:
    """Host-side upper bound of the normalized width, for bucket selection
    (the exact width depends on the ink spread measured on the device; the
    prepare clips to out_T and reports true lengths)."""
    est = 0
    for im in images:
        h, w = im.shape
        est = max(est, int(w * max(target_height / max(h, 1), 1.0) * 1.25))
    return est + 2 * pad


# ---------------------------------------------------------------------------
# Train-time augmentation
# ---------------------------------------------------------------------------

def augment_generator(seed: int, step: int, device,
                      *fold: int) -> torch.Generator:
    """The generator of a training step's augmentation draws, seeded from
    (seed, step) — the counterpart of the JAX package's
    fold_in(PRNGKey(seed), step): each step draws afresh, and a rerun
    draws the same. ``fold`` adds more numbers to the seed (a data-parallel
    rank folds in its rank, as the JAX package folds in the axis index)."""
    s = np.random.SeedSequence([int(seed), int(step),
                                *map(int, fold)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s) >> 1)


def augment_lines(generator: torch.Generator, x: torch.Tensor,
                  lengths: torch.Tensor, strength: float = 1.0):
    """Random per-line distortions of a prepared batch [B, T, H], drawn from
    ``generator`` on x's device: amplitude scale U(0.8, 1.2), additive
    gaussian pixel noise (std 0.05), time shift U{-4..4} frames and height
    shift U{-2..2} rows, all at strength 1.0 (see augment_lines_with)."""
    B, T, H = x.shape
    dev = x.device
    u = torch.empty((B, 1, 1), device=dev).uniform_(-1.0, 1.0,
                                                    generator=generator)
    amp = 1.0 + 0.2 * strength * u
    noise = 0.05 * strength * torch.randn((B, T, H), device=dev,
                                          generator=generator)
    max_t = max(int(round(4 * strength)), 0)
    max_h = max(int(round(2 * strength)), 0)
    sh_t = torch.randint(-max_t, max_t + 1, (B,), device=dev,
                         generator=generator)
    sh_h = torch.randint(-max_h, max_h + 1, (B,), device=dev,
                         generator=generator)
    return augment_lines_with(x, lengths, amp, noise, sh_t, sh_h)


def augment_lines_with(x: torch.Tensor, lengths: torch.Tensor,
                       amp: torch.Tensor, noise: torch.Tensor,
                       sh_t: torch.Tensor, sh_h: torch.Tensor):
    """The distortions of augment_lines for given draws: amp [B, 1, 1],
    noise [B, T, H], integer shifts sh_t, sh_h [B]. Shifts are true
    translations with zero fill (not circular rolls); prepared lines carry
    16 blank pad frames, so time shifts never clip ink, while a height
    shift can clip 1-2 edge rows (intended distortion). The result is
    clipped to [0, 1.5] and padded frames are zero again."""
    B, T, H = x.shape
    dev = x.device
    sh_t, sh_h = sh_t.long(), sh_h.long()
    t_src = torch.arange(T, device=dev)[None, :] - sh_t[:, None]      # [B, T]
    h_src = torch.arange(H, device=dev)[None, :] - sh_h[:, None]      # [B, H]
    t_ok = (t_src >= 0) & (t_src < T)
    h_ok = (h_src >= 0) & (h_src < H)
    zero = x.new_zeros(())
    y = torch.gather(x, 1, torch.clamp(t_src, 0, T - 1)[:, :, None]
                     .expand(B, T, H))
    y = torch.where(t_ok[:, :, None], y, zero)
    y = torch.gather(y, 2, torch.clamp(h_src, 0, H - 1)[:, None, :]
                     .expand(B, T, H))
    y = torch.where(h_ok[:, None, :], y, zero)
    mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None])[:, :,
                                                                    None]
    y = torch.clamp(y * amp + noise, 0.0, 1.5)
    return torch.where(mask, y, zero).to(x.dtype)
