"""The family of clstm's bidirectional nets, Stacked[Parallel(NPLSTM,
Reversed(NPLSTM)) x n, SoftmaxLayer] (the prefab kinds ``bidi`` and
``bidi2``): everything the benchmark knows of this layer graph. A
configuration names this file under "reference"; the harness, the driver,
the readers and the tests find it there and name no graph themselves.

The plain forward, in PyTorch, written out from the net's equations.
Weights (``make_weights``): per bidi layer {"Wx": [2, D, 4H], "Wh": [2, H,
4H], "b": [2, 4H]} (direction 0 forward, 1 reversed; gate order input,
forget, output, cell candidate), then the softmax {"W": [2H, C], "b":
[C]}. Per frame and direction:
  z = x_t·Wx + b + h·Wh;  i, f, o = sigmoid;  g = tanh
  c' = f·c + i·g;  h' = tanh(c')·o
padded frames (t >= length) emit zeros and carry (h, c) unchanged; the
reversed direction runs on each row reversed within its length. The
softmax layer's logits are [y_fwd | y_rev]·W + b. Arithmetic is f32 with
TF32 off, or a control's lower precision (precision.py).

Beside it: the program's build of the net (``build_args``) and its
parameter names (``program_names``), the frames the alignment runs over
(``out_lengths``), the CPU tests' size (``tiny``), and the pricing of the
graph's work (``flop_per_frame``, ``STEP_BOUNDS``). Nothing here imports
the program.
"""

from __future__ import annotations

from typing import Callable

import torch

from portbench import bounds
from portbench.reference.precision import rounder


def make_weights(cfg: dict, gen: torch.Generator, scale, device) -> list:
    """The weights of ``cfg`` drawn uniform in [-s, s] from ``gen``, one
    draw of every parameter at once. ``scale`` is a number for every
    parameter, or a dict with "Wx", "Wh" and "b" for the bidi layers and
    "softmax" for the output layer."""
    if not isinstance(scale, dict):
        scale = {"Wx": scale, "Wh": scale, "b": scale, "softmax": scale}
    shapes, D = [], cfg["ninput"]
    for H in cfg["nhidden_layers"]:
        shapes.append({"Wx": (2, D, 4 * H), "Wh": (2, H, 4 * H),
                       "b": (2, 4 * H)})
        D = 2 * H
    shapes.append({"W": (D, cfg["noutput"]), "b": (cfg["noutput"],)})
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


def leaves(weights: list) -> dict:
    """The weights as the net's leaves, by name: per bidi layer i and
    direction d (fwd, rev) "L{i}.{d}.{Wx,Wh,b}", then "out.W", "out.b"."""
    out = {}
    for i, w in enumerate(weights[:-1]):
        for k, d in enumerate(("fwd", "rev")):
            for n in ("Wx", "Wh", "b"):
                out[f"L{i}.{d}.{n}"] = w[n][k]
    out["out.W"] = weights[-1]["W"]
    out["out.b"] = weights[-1]["b"]
    return out


def flip_within(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row of [B, T, ...] reversed within its length, the padding in
    place."""
    T = x.shape[1]
    j = torch.arange(T, device=x.device)[None, :]
    L = lengths.to(x.device).long()[:, None]
    idx = torch.where(j < L, L - 1 - j, j)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def bidi_layer(w: dict, x: torch.Tensor, lengths: torch.Tensor,
               q: Callable) -> torch.Tensor:
    """One Parallel(NPLSTM, Reversed(NPLSTM)) layer: x [B, T, D] ->
    [B, T, 2H], both directions stepped together."""
    B, T, _ = x.shape
    H = w["Wh"].shape[1]
    xs = torch.stack([x, flip_within(x, lengths)])            # [2, B, T, D]
    xz = torch.matmul(q(xs), q(w["Wx"])[:, None]) + w["b"][:, None, None]
    Wh = q(w["Wh"])
    valid = (torch.arange(T, device=x.device)[None, :]
             < lengths.to(x.device)[:, None])                  # [B, T]
    h = x.new_zeros((2, B, H))
    c = x.new_zeros((2, B, H))
    ys = []
    for t in range(T):
        z = xz[:, :, t] + torch.bmm(q(h), Wh)
        i = torch.sigmoid(z[..., :H])
        f = torch.sigmoid(z[..., H:2 * H])
        o = torch.sigmoid(z[..., 2 * H:3 * H])
        g = torch.tanh(z[..., 3 * H:])
        c2 = f * c + i * g
        h2 = torch.tanh(c2) * o
        m = valid[None, :, t, None]
        c = torch.where(m, c2, c)
        h = torch.where(m, h2, h)
        ys.append(torch.where(m, h2, torch.zeros_like(h2)))
    y = torch.stack(ys, dim=2)                                 # [2, B, T, H]
    return torch.cat([y[0], flip_within(y[1], lengths)], dim=-1)


def logits(weights: list, x: torch.Tensor, lengths: torch.Tensor,
           rounding: str = "f32") -> torch.Tensor:
    """The net's pre-softmax outputs [B, T, C] for frames x [B, T, D]."""
    q = rounder(rounding)
    y = x.float()
    for w in weights[:-1]:
        y = bidi_layer(w, y, lengths, q)
    sm = weights[-1]
    return torch.matmul(q(y), q(sm["W"])) + sm["b"]


def out_lengths(cfg: dict, lengths):
    """The frames of each line the alignment runs over: every input frame
    (the net keeps the frame count)."""
    return lengths


# -- the program's net ------------------------------------------------------

def build_args(cfg: dict) -> dict:
    """The keyword arguments, beside the codec and the kind cfg["net"], with
    which the CLIs' ``createBidi`` builds the net: the first layer's units,
    and the second's where there is one."""
    hs = cfg["nhidden_layers"]
    args = {"nhidden": hs[0]}
    if len(hs) > 1:
        args["nhidden2"] = hs[1]
    return args


def program_names(cfg: dict) -> dict:
    """The reference's leaf names -> the program's parameter names
    (Stacked[Parallel(NPLSTM, Reversed(NPLSTM)) ..., SoftmaxLayer])."""
    out = {}
    n = len(cfg["nhidden_layers"])
    for i in range(n):
        for d, path in (("fwd", f"sub.{i}.sub.0"),
                        ("rev", f"sub.{i}.sub.1.sub.0")):
            for w in ("Wx", "Wh", "b"):
                out[f"L{i}.{d}.{w}"] = f"{path}.{w}"
    out["out.W"] = f"sub.{n}.W"
    out["out.b"] = f"sub.{n}.b"
    return out


def tiny(cfg: dict) -> dict:
    """The overrides that bring a cell of this family to a size a CPU test
    holds, in f32: 8 units in each of the configuration's layers, 12
    classes, 48 lines of 40-120 frames, B=8, K=3."""
    return {"cfg": {"nhidden_layers": [8] * len(cfg["nhidden_layers"]),
                    "noutput": 12, "precision": "f32"},
            "mix": {"lines": 48, "width_min": 40, "width_max": 120,
                    "cell_cols": 11, "glyph_cols": [6, 9],
                    "batch_size": 8, "steps_per_dispatch": 3}}


# -- pricing (the yardstick's arithmetic for this graph; bounds.py) ---------

def layers(cfg: dict) -> list:
    """The bidi layers of a configuration as (D, H) pairs, input first."""
    D, out = cfg["ninput"], []
    for H in cfg["nhidden_layers"]:
        out.append((D, H))
        D = 2 * H
    return out


def flop_per_frame(cfg: dict, train: bool) -> int:
    """Matrix flop a valid frame costs: per bidi layer 2·4H(D+1+H) for each
    direction's z, plus the softmax's C(2H+1), times 2 for a multiply-add;
    a training step is three times its forward (forward, and the two
    products of the backward)."""
    per = sum(2 * 4 * H * (D + 1 + H) for D, H in layers(cfg))
    per += cfg["noutput"] * (2 * cfg["nhidden_layers"][-1] + 1)
    return (3 if train else 1) * 2 * per


def lstm_step_bound_ms(cfg: dict, B: int, T: int, V: int,
                       train: bool) -> float:
    """The bound of one step's LSTM work, summed over the layers: in
    training the forward with state (K1, or K4 on a hoisted projection),
    the chain and the contractions (dx from the second layer on, whose
    input is a layer's output); in serving the forward alone."""
    e = 2 if cfg["precision"] == "bf16" else 4
    total = 0.0
    for i, (D, H) in enumerate(layers(cfg)):
        fwd = "xz" if bounds.hoists(D, H) else "fwd"
        if not train:
            total += bounds.lstm_bound(fwd, B, T, D, H, V, esize=e)[0]
            continue
        total += bounds.lstm_bound(fwd + "_state", B, T, D, H, V, esize=e)[0]
        total += bounds.lstm_bound("chain", B, T, D, H, V, esize=e)[0]
        total += bounds.lstm_bound("reduce", B, T, D, H, V, dx=i > 0,
                                   esize=e)[0]
    return total


def affine_step_bound_ms(cfg: dict, B: int, T: int, V: int) -> float:
    """The bound of one training step's affine work: the softmax layer's
    forward z = [x|1]·W, dx = dz·Wᵀ and dW = xᵀ·dz, and the hoisted input
    product's forward (where the layer hoists; its backward is the LSTM
    layer's contractions). Flop and reads at the V valid frames, writes at
    all B·T, operands at the configuration's precision, z and dz f32."""
    pk = bounds.peaks("H100")
    e = 2 if cfg["precision"] == "bf16" else 4
    peak = pk["bf16_flops"] if e == 2 else pk["f32_mma_flops"]
    hbm = pk["hbm_bytes_per_s"]
    X, C = 2 * cfg["nhidden_layers"][-1], cfg["noutput"]
    works = [
        (2 * V * (X + 1) * C, e * (V * X + (X + 1) * C) + 4 * B * T * C),
        (2 * V * C * X, 4 * V * C + e * X * C + e * B * T * X),
        (2 * V * X * C, e * V * X + 4 * V * C + 4 * (X + 1) * C)]
    for D, H in layers(cfg):
        if bounds.hoists(D, H):
            works.append((2 * V * (D + 1) * 8 * H,
                          e * (V * D + (D + 1) * 8 * H + B * T * 8 * H)))
    return sum(bounds.bound(f, b, peak, hbm)[0] for f, b in works)


# The bound functions of this graph's layers that a kernel entry or a
# reader can name (bounds.step_bound looks here first): each prices one
# step's work from a step record (B, T, S, V, train) and the configuration.
STEP_BOUNDS = {
    "lstm": lambda cfg, st: lstm_step_bound_ms(cfg, st["B"], st["T"],
                                               st["V"], st["train"]),
    "affine": lambda cfg, st: (affine_step_bound_ms(cfg, st["B"], st["T"],
                                                    st["V"])
                               if st["train"] else 0.0),
}
