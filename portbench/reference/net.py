"""The stacked bidirectional LSTM net with a softmax output, in plain
PyTorch: clstm's Stacked[Parallel(NPLSTM, Reversed(NPLSTM)) x n,
SoftmaxLayer], written out from its equations.

Weights (the benchmark's layout, ``make_weights``): per bidi layer
{"Wx": [2, D, 4H], "Wh": [2, H, 4H], "b": [2, 4H]} (direction 0 forward,
1 reversed; gate order input, forget, output, cell candidate), then the
softmax {"W": [2H, C], "b": [C]}. Per frame and direction:
  z = x_t·Wx + b + h·Wh;  i, f, o = sigmoid;  g = tanh
  c' = f·c + i·g;  h' = tanh(c')·o
padded frames (t >= length) emit zeros and carry (h, c) unchanged; the
reversed direction runs on each row reversed within its length. The
softmax layer's logits are [y_fwd | y_rev]·W + b.

Arithmetic is f32 with TF32 off. ``rounding`` puts a lower precision in
its place for the controls: "fp8" rounds every operand of a product, and
on the way back every cotangent that reaches one, to float8 e4m3 with a
per-tensor scale (the tensor's largest magnitude at 448), products
accumulating in f32.
"""

from __future__ import annotations

from typing import Callable

import torch


def set_strict_f32() -> None:
    """f32 products in f32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax()
    s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def rounder(rounding: str) -> Callable:
    """The operand rounding of a precision: "f32" none, "fp8" scaled e4m3."""
    if rounding == "f32":
        return lambda t: t
    if rounding == "fp8":
        return _Fp8.apply
    raise ValueError(f"unknown rounding {rounding!r}")


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
