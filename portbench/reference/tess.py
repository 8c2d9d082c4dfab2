"""The family of Tesseract 4/5's LSTM line recogniser, the VGSL net
"[1,36,0,1 Ct3,3,16 Mp3,3 Lfys64 Lfx96 Lrx96 Lfx512 O1c1]" of tessdata_best's
``eng`` (the prefab kind ``vgsl``): everything the benchmark knows of this
layer graph. A configuration names this file under "reference"; the
harness, `drivers/train.py`, the readers and the tests find it there.

The plain forward, in PyTorch, written out from the layers' equations, on a
line of frames x [B, T, ny] (ny = 36 rows, ink in [0, 1]) read as a
one-channel image ny high and T wide:
  conv   z[t, y, f] = Σ_{dy, dx} x[t + dx - 1, y + dy - 1]·W[3 dy + dx, f]
         + b[f], zero outside the image and past the line's length; tanh
  pool   the maximum over non-overlapping 3 x 3 windows (rows, frames) ->
         [ceil(T/3), ny/3, f]; a partial window at the line's end is pooled
         over its frames inside the line; frames past ceil(len/3) are 0
  ysum   an LSTM of 64 units down each pooled column, its ny/3 rows top to
         bottom as steps, keeping the last h: [ceil(T/3), 64]
  L0     an LSTM of 96 units forward along the pooled frames
  L1     an LSTM of 96 units reversed (within each line's length) on L0's
  L2     an LSTM of 512 units forward
  out    logits = y·W + b over the classes
Every LSTM is clstm's NPLSTM: z = x_t·Wx + b + h·Wh; i, f, o sigmoid, g
tanh; c' = f·c + i·g; h' = tanh(c')·o; padded steps emit zeros and keep
(h, c). Arithmetic is f32 with TF32 off, or a control's lower precision
(precision.py: every product's operands rounded).

Where this departs from Tesseract (tessdata_best's weights are not used:
they are drawn from the seed, so the departures change no measured work):
  - Tesseract clips the LSTM cell state to [-9, 9] (its kStateClip); here,
    as in the program, the cell is not clipped;
  - the input is ink in [0, 1] (the benchmark's prepared lines), not
    Tesseract's normalised grey;
  - the summarising LSTM runs top to bottom (Tesseract's Lfys runs its y
    LSTM in the forward direction of its transposed image);
  - a partial last pool window is pooled over its valid frames (Tesseract
    pools a window over the image, and its width is a multiple of the
    pool's after its own padding).

Weights (``make_weights``), one dict a layer: conv {"W": [9, F], "b":
[F]}; ysum and each of L0-L2 {"Wx": [D, 4H], "Wh": [H, 4H], "b": [4H]}
(gate order input, forget, output, cell candidate); out {"W": [H2, C],
"b": [C]}.

Beside it: the program's build of the net (``build_args``) and its
parameter names (``program_names``), the frames the alignment runs over
(``out_lengths``: ceil(len/3)), the CPU tests' size (``tiny``), and the
pricing of the graph's work (``flop_per_frame``, ``STEP_BOUNDS``). Nothing
here imports the program.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from portbench import bounds
from portbench.reference.precision import rounder

# The convolution's and the pool's windows (Ct3,3 and Mp3,3), and the pool's
# step along the frames.
KY = KX = 3
POOL = 3


def spec_of(cfg: dict) -> str:
    """The VGSL string of the configuration's widths."""
    l0, l1, l2 = cfg["nhidden_layers"]
    return (f"[1,{cfg['ninput']},0,1 Ct{KY},{KX},{cfg['nfilters']} "
            f"Mp{POOL},{POOL} Lfys{cfg['nhidden_ysum']} Lfx{l0} Lrx{l1} "
            f"Lfx{l2} O1c1]")


def _shapes(cfg: dict) -> list:
    nf, hy = cfg["nfilters"], cfg["nhidden_ysum"]
    out = [{"W": (KY * KX, nf), "b": (nf,)}]
    D = nf
    for H in [hy] + list(cfg["nhidden_layers"]):
        out.append({"Wx": (D, 4 * H), "Wh": (H, 4 * H), "b": (4 * H,)})
        D = H
    out.append({"W": (D, cfg["noutput"]), "b": (cfg["noutput"],)})
    return out


def make_weights(cfg: dict, gen: torch.Generator, scale, device) -> list:
    """The weights of ``cfg`` drawn uniform in [-s, s] from ``gen``, one
    draw of every parameter at once; ``scale`` is a number for every
    parameter, or a dict by parameter name ("W", "b", "Wx", "Wh";
    "softmax" for the output layer's)."""
    if not isinstance(scale, dict):
        scale = {"W": scale, "b": scale, "Wx": scale, "Wh": scale,
                 "softmax": scale}
    shapes = _shapes(cfg)
    n = sum(int(torch.Size(s).numel()) for layer in shapes
            for s in layer.values())
    flat = torch.rand(n, generator=gen, device=device) * 2.0 - 1.0
    out, at = [], 0
    for i, layer in enumerate(shapes):
        last = i == len(shapes) - 1
        ws = {}
        for name, shape in layer.items():
            k = int(torch.Size(shape).numel())
            s = scale["softmax"] if last else scale[name]
            ws[name] = (flat[at:at + k] * s).reshape(shape)
            at += k
        out.append(ws)
    return out


NAMES = ("conv", "ysum", "L0", "L1", "L2", "out")


def leaves(weights: list) -> dict:
    """The weights as the net's leaves, by name: "conv.W", "conv.b",
    "ysum.{Wx,Wh,b}", "L0.*", "L1.*", "L2.*", "out.W", "out.b"."""
    return {f"{layer}.{k}": v for layer, w in zip(NAMES, weights)
            for k, v in w.items()}


def _valid(lengths: torch.Tensor, T: int, device) -> torch.Tensor:
    return (torch.arange(T, device=device)[None, :]
            < lengths.to(device)[:, None])


def flip_within(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row of [B, T, ...] reversed within its length, the padding in
    place."""
    T = x.shape[1]
    j = torch.arange(T, device=x.device)[None, :]
    L = lengths.to(x.device).long()[:, None]
    idx = torch.where(j < L, L - 1 - j, j)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def lstm(w: dict, x: torch.Tensor, lengths: torch.Tensor, q: Callable,
         reverse: bool = False) -> torch.Tensor:
    """One NPLSTM over x [B, T, D] -> y [B, T, H]; ``reverse`` runs it on
    each row reversed within its length (Reversed(NPLSTM))."""
    if reverse:
        return flip_within(lstm(w, flip_within(x, lengths), lengths, q),
                           lengths)
    B, T, _ = x.shape
    H = w["Wh"].shape[0]
    xz = torch.matmul(q(x), q(w["Wx"])) + w["b"]
    Wh = q(w["Wh"])
    valid = _valid(lengths, T, x.device)
    h = x.new_zeros((B, H))
    c = x.new_zeros((B, H))
    ys = []
    for t in range(T):
        z = xz[:, t] + torch.matmul(q(h), Wh)
        i = torch.sigmoid(z[:, :H])
        f = torch.sigmoid(z[:, H:2 * H])
        o = torch.sigmoid(z[:, 2 * H:3 * H])
        g = torch.tanh(z[:, 3 * H:])
        c2 = f * c + i * g
        h2 = torch.tanh(c2) * o
        m = valid[:, t, None]
        c = torch.where(m, c2, c)
        h = torch.where(m, h2, h)
        ys.append(torch.where(m, h2, torch.zeros_like(h2)))
    return torch.stack(ys, dim=1)


def conv_pool(w: dict, x: torch.Tensor, lengths: torch.Tensor,
              q: Callable) -> torch.Tensor:
    """Ct3,3,F then Mp3,3: x [B, T, ny] -> [B, ceil(T/3), ceil(ny/3)·F],
    rows then filters, 0 past each line's pooled length."""
    B, T, ny = x.shape
    nf = w["W"].shape[1]
    valid = _valid(lengths, T, x.device)
    img = torch.where(valid[..., None], x, torch.zeros_like(x))
    pad = F.pad(img, (KY // 2, KY // 2, KX // 2, KX // 2))    # rows, frames
    z = w["b"].expand(B, T, ny, nf)
    W = q(w["W"])
    for dy in range(KY):
        for dx in range(KX):
            z = z + (q(pad[:, dx:dx + T, dy:dy + ny])[..., None]
                     * W[dy * KX + dx])
    y = torch.tanh(z)                                          # [B,T,ny,F]
    y = torch.where(valid[..., None, None], y,
                    torch.full_like(y, float("-inf")))
    To, nyo = -(-T // POOL), -(-ny // KY)
    y = F.pad(y, (0, 0, 0, nyo * KY - ny, 0, To * POOL - T),
              value=float("-inf"))
    p = y.reshape(B, To, POOL, nyo, KY, nf).amax(dim=(2, 4))  # [B,To,nyo,F]
    ovalid = _valid(out_lengths(None, lengths), To, x.device)
    p = torch.where(ovalid[..., None, None], p, torch.zeros_like(p))
    return p.reshape(B, To, nyo * nf)


def ysum(w: dict, x: torch.Tensor, lengths: torch.Tensor,
         q: Callable) -> torch.Tensor:
    """Lfys: an LSTM down each column of x [B, To, rows·F] (rows as steps,
    top to bottom), the last output kept -> [B, To, H]; a column past the
    line's pooled length has no step."""
    B, To, _ = x.shape
    nc = w["Wx"].shape[0]
    rows = x.shape[2] // nc
    col_len = _valid(lengths, To, x.device).reshape(-1).long() * rows
    y = lstm(w, x.reshape(B * To, rows, nc), col_len, q)
    return y[:, -1].reshape(B, To, -1)


def logits(weights: list, x: torch.Tensor, lengths: torch.Tensor,
           rounding: str = "f32") -> torch.Tensor:
    """The net's pre-softmax outputs [B, ceil(T/3), C] for frames x
    [B, T, ny] of ``lengths``."""
    q = rounder(rounding)
    conv, ys, l0, l1, l2, out = weights
    lo = out_lengths(None, lengths)
    y = conv_pool(conv, x.float(), lengths, q)
    y = ysum(ys, y, lo, q)
    y = lstm(l0, y, lo, q)
    y = lstm(l1, y, lo, q, reverse=True)
    y = lstm(l2, y, lo, q)
    return torch.matmul(q(y), q(out["W"])) + out["b"]


def out_lengths(cfg, lengths):
    """The frames of each line the alignment runs over: ceil(len/3), the
    pool's output frames (numpy or torch, as given)."""
    return (lengths + (POOL - 1)) // POOL


# -- the program's net ------------------------------------------------------

def build_args(cfg: dict) -> dict:
    """The keyword arguments, beside the codec and the kind cfg["net"]
    ("vgsl"), with which the CLIs' ``createBidi`` builds the net: the VGSL
    string (its widths the configuration's), and ``nhidden`` (unused by
    the kind, which takes every width from the string: the last layer's)."""
    spec = spec_of(cfg)
    if cfg.get("spec", spec) != spec:
        raise ValueError(f"the configuration's spec {cfg['spec']!r} is not "
                         f"its widths' {spec!r}")
    return {"nhidden": cfg["nhidden_layers"][-1], "spec": spec}


def program_names(cfg: dict) -> dict:
    """The reference's leaf names -> the program's parameter names
    (Stacked[Conv2D, MaxPool2D, NPLSTMYSum, NPLSTM, Reversed(NPLSTM),
    NPLSTM, SoftmaxLayer])."""
    paths = {"conv": "sub.0", "ysum": "sub.2", "L0": "sub.3",
             "L1": "sub.4.sub.0", "L2": "sub.5", "out": "sub.6"}
    return {leaf: f"{paths[leaf.split('.')[0]]}.{leaf.split('.')[1]}"
            for leaf in leaves(make_weights(
                cfg, torch.Generator().manual_seed(0), 0.0, "cpu"))}


def tiny(cfg: dict) -> dict:
    """The overrides that bring a cell of this family to a size a CPU test
    holds, in f32: 4 filters, LSTMs of 5, 6, 7 and 8 units, 12 classes, 48
    lines of 40-120 frames (11 frames a glyph: about 4 pooled frames),
    B=8, K=3."""
    small = dict(cfg, nfilters=4, nhidden_ysum=5, nhidden_layers=[6, 7, 8])
    return {"cfg": {"nfilters": 4, "nhidden_ysum": 5,
                    "nhidden_layers": [6, 7, 8], "spec": spec_of(small),
                    "noutput": 12, "precision": "f32"},
            "mix": {"lines": 48, "width_min": 40, "width_max": 120,
                    "cell_cols": 11, "glyph_cols": [6, 9],
                    "batch_size": 8, "steps_per_dispatch": 3}}


# -- pricing (the yardstick's arithmetic for this graph; bounds.py) ---------

def lstms(cfg: dict) -> list:
    """The LSTM layers as (D, H, steps) with steps "col" (the column LSTM:
    a sequence of ceil(ny/3) steps a pooled frame) or "x" (along the
    pooled frames), input first."""
    rows = -(-cfg["ninput"] // KY)
    out = [(cfg["nfilters"], cfg["nhidden_ysum"], rows)]
    D = cfg["nhidden_ysum"]
    for H in cfg["nhidden_layers"]:
        out.append((D, H, 0))
        D = H
    return out


def layers(cfg: dict) -> list:
    """The LSTM layers of a configuration as (D, H) pairs, input first (the
    interface scripts/torch_span_account.py reads)."""
    return [(D, H) for D, H, _ in lstms(cfg)]


def flop_per_frame(cfg: dict, train: bool) -> float:
    """Matrix flop a valid input frame costs: the convolution's
    ny·F·(9+1) multiply-adds a frame, and a third (the pool's step) of a
    pooled frame's: each LSTM's 4H(D+1+H) a step (the column LSTM's
    ceil(ny/3) steps), the softmax's C(H+1); times 2 for a multiply-add; a
    training step is three times its forward."""
    conv = cfg["ninput"] * cfg["nfilters"] * (KY * KX + 1)
    pooled = sum(4 * H * (D + 1 + H) * (steps or 1)
                 for D, H, steps in lstms(cfg))
    pooled += cfg["noutput"] * (cfg["nhidden_layers"][-1] + 1)
    return (3 if train else 1) * 2 * (conv + pooled / POOL)


def lstm1_bound(kind: str, B, T, D, H, V, dx=False, esize=2):
    """bounds.lstm_bound's work for ONE direction (a lone layer): the
    forward with the state the backward reads ("fwd_state"), the chain
    ("chain") or the contractions ("reduce"), at [B, T] with V valid
    frames; streams read at the V valid frames, written at all B·T; the
    gates and dW f32."""
    pk = bounds.peaks("H100")
    G, BT, e = 4 * H, B * T, esize
    peak = pk["f32_mma_flops"] if e == 4 else pk["bf16_flops"]
    hbm = pk["hbm_bytes_per_s"]

    def state(n):
        return n * (4 * G + e * H)
    if kind == "fwd_state":
        flop = 2 * V * (D + 1 + H) * G
        nbytes = (e * (V * D + (D + 1 + H) * G + BT * H) + 4 * B
                  + state(BT))
    elif kind == "chain":
        flop = 2 * V * G * H
        nbytes = state(V) + e * (V * H + H * G + BT * G) + 4 * B
    elif kind == "reduce":
        flop = 2 * V * (D + 1 + H) * G + (2 * V * G * D if dx else 0)
        nbytes = (e * (V * D + V * H + V * G + (D * G + BT * D if dx else 0))
                  + 4 * (D + 1 + H) * G)
    else:
        raise ValueError(f"unknown LSTM work {kind!r}")
    return bounds.bound(flop, nbytes, peak, hbm)


def _pooled(st: dict) -> tuple:
    """(pooled frames of the bucket, valid pooled frames) of a step record:
    ceil(T/3), and V/3 (each line's ceil(len/3) is at most a frame more)."""
    return -(-st["T"] // POOL), st["V"] / POOL


def lstm_layer_ms(cfg: dict, st: dict, which) -> float:
    """The bound of one step's work of the LSTM layers ``which`` (indices
    into ``lstms``): the forward with state, the chain and the
    contractions (dx: every layer's input is another layer's output); in
    serving the forward alone."""
    e = 2 if cfg["precision"] == "bf16" else 4
    B = st["B"]
    Tp, Vp = _pooled(st)
    total = 0.0
    for i in which:
        D, H, steps = lstms(cfg)[i]
        shape = ((B * Tp, steps, Vp * steps) if steps else (B, Tp, Vp))
        total += lstm1_bound("fwd_state", *shape[:2], D, H, shape[2],
                             esize=e)[0]
        if st["train"]:
            total += lstm1_bound("chain", *shape[:2], D, H, shape[2],
                                 esize=e)[0]
            total += lstm1_bound("reduce", *shape[:2], D, H, shape[2],
                                 dx=True, esize=e)[0]
    return total


def affine_step_bound_ms(cfg: dict, st: dict) -> float:
    """The bound of one training step's softmax work over the pooled
    frames: z = [x|1]·W, dx = dz·Wᵀ and dW = xᵀ·dz (bidi.py's, at the
    pooled frames)."""
    pk = bounds.peaks("H100")
    e = 2 if cfg["precision"] == "bf16" else 4
    peak = pk["bf16_flops"] if e == 2 else pk["f32_mma_flops"]
    hbm = pk["hbm_bytes_per_s"]
    X, C = cfg["nhidden_layers"][-1], cfg["noutput"]
    B = st["B"]
    Tp, V = _pooled(st)
    works = [
        (2 * V * (X + 1) * C, e * (V * X + (X + 1) * C) + 4 * B * Tp * C),
        (2 * V * C * X, 4 * V * C + e * X * C + e * B * Tp * X),
        (2 * V * X * C, e * V * X + 4 * V * C + 4 * (X + 1) * C)]
    return sum(bounds.bound(f, b, peak, hbm)[0] for f, b in works)


def conv_step_bound_ms(cfg: dict, st: dict) -> float:
    """The bound of one step's convolution, tanh and pool: the forward's
    9·ny·F multiply-adds a valid frame, x read, the ny·F-wide activations
    written and read by the pool, the pooled [ceil(ny/3)·F] frames written;
    in training the backward's dW products (the same flop), the pooled
    gradient read, the activations' gradient written and read with the
    activations, x read again. No dx: the input is the data."""
    pk = bounds.peaks("H100")
    e = 2 if cfg["precision"] == "bf16" else 4
    peak = pk["bf16_flops"] if e == 2 else pk["f32_mma_flops"]
    hbm = pk["hbm_bytes_per_s"]
    ny, nf = cfg["ninput"], cfg["nfilters"]
    B, T, V = st["B"], st["T"], st["V"]
    Tp = -(-T // POOL)
    act, pooled = B * T * ny * nf, B * Tp * -(-ny // KY) * nf
    flop = 2 * V * ny * nf * KY * KX
    nbytes = e * (V * ny + 2 * act + pooled)
    if st["train"]:
        flop *= 2
        nbytes += e * (pooled + 3 * act + V * ny)
    return bounds.bound(flop, nbytes, peak, hbm)[0]


def ctc_step_bound_ms(cfg: dict, st: dict) -> float:
    """The alignment's bound over the pooled frames (bounds.ctc_bound)."""
    if not st["train"]:
        return 0.0
    return bounds.ctc_step_bound_ms(st["B"], -(-st["T"] // POOL), st["S"])


# The bound functions of this graph's layers that a kernel entry or a
# reader can name (bounds.step_bound looks here first): each prices one
# step's work from a step record (B, T, S, V, train; T and V the input's
# frames) and the configuration.
STEP_BOUNDS = {
    "lstm": lambda cfg, st: lstm_layer_ms(cfg, st, range(4)),
    "ysum": lambda cfg, st: lstm_layer_ms(cfg, st, [0]),
    "affine": lambda cfg, st: (affine_step_bound_ms(cfg, st)
                               if st["train"] else 0.0),
    "ctc": ctc_step_bound_ms,
    "conv": conv_step_bound_ms,
}
