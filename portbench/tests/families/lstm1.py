"""A family of another layer graph, for the benchmark's own tests: clstm's
prefab ``lstm1``, Stacked[NPLSTM, SoftmaxLayer], one forward LSTM and a
softmax. test_portbench_manifest.py copies it into a copy of the benchmark
as reference/lstm1.py, beside a configuration and a cell of its own, and
runs that cell: a configuration of another graph needs files and entries
alone.

Weights: [{"Wx": [D, 4H], "Wh": [H, 4H], "b": [4H]}, {"W": [H, C], "b":
[C]}]; per frame z = x_t·Wx + b + h·Wh, gates input, forget, output, cell
candidate; c' = f·c + i·g; h' = tanh(c')·o; padded frames emit zeros and
carry (h, c); logits h·W + b. Plain PyTorch, f32 or a control's rounding.
"""

from __future__ import annotations

import torch

from portbench import bounds
from portbench.reference.precision import rounder


def make_weights(cfg: dict, gen: torch.Generator, scale, device) -> list:
    """The weights drawn uniform in [-scale, scale] in one draw."""
    D, H, C = cfg["ninput"], cfg["nhidden"], cfg["noutput"]
    shapes = [{"Wx": (D, 4 * H), "Wh": (H, 4 * H), "b": (4 * H,)},
              {"W": (H, C), "b": (C,)}]
    n = sum(int(torch.Size(s).numel()) for w in shapes for s in w.values())
    flat = (torch.rand(n, generator=gen, device=device) * 2.0 - 1.0) * scale
    out, at = [], 0
    for w in shapes:
        ws = {}
        for name, shape in w.items():
            k = int(torch.Size(shape).numel())
            ws[name] = flat[at:at + k].reshape(shape)
            at += k
        out.append(ws)
    return out


def leaves(weights: list) -> dict:
    w, sm = weights
    return {"L0.Wx": w["Wx"], "L0.Wh": w["Wh"], "L0.b": w["b"],
            "out.W": sm["W"], "out.b": sm["b"]}


def logits(weights: list, x: torch.Tensor, lengths: torch.Tensor,
           rounding: str = "f32") -> torch.Tensor:
    q = rounder(rounding)
    w, sm = weights
    B, T, _ = x.shape
    H = w["Wh"].shape[0]
    xz = torch.matmul(q(x.float()), q(w["Wx"])) + w["b"]
    Wh = q(w["Wh"])
    valid = (torch.arange(T, device=x.device)[None, :]
             < lengths.to(x.device)[:, None])
    h = x.new_zeros((B, H))
    c = x.new_zeros((B, H))
    ys = []
    for t in range(T):
        z = xz[:, t] + torch.matmul(q(h), Wh)
        i, f, o = (torch.sigmoid(z[:, k * H:(k + 1) * H]) for k in range(3))
        c2 = f * c + i * torch.tanh(z[:, 3 * H:])
        h2 = torch.tanh(c2) * o
        m = valid[:, t, None]
        c = torch.where(m, c2, c)
        h = torch.where(m, h2, h)
        ys.append(torch.where(m, h2, torch.zeros_like(h2)))
    return torch.matmul(q(torch.stack(ys, dim=1)), q(sm["W"])) + sm["b"]


def out_lengths(cfg: dict, lengths):
    return lengths


def build_args(cfg: dict) -> dict:
    return {"nhidden": cfg["nhidden"]}


def program_names(cfg: dict) -> dict:
    return {"L0.Wx": "sub.0.Wx", "L0.Wh": "sub.0.Wh", "L0.b": "sub.0.b",
            "out.W": "sub.1.W", "out.b": "sub.1.b"}


def tiny(cfg: dict) -> dict:
    return {"cfg": {"nhidden": 8, "noutput": 12, "precision": "f32"},
            "mix": {"lines": 48, "width_min": 40, "width_max": 120,
                    "cell_cols": 11, "glyph_cols": [6, 9],
                    "batch_size": 8, "steps_per_dispatch": 3}}


def flop_per_frame(cfg: dict, train: bool) -> int:
    D, H, C = cfg["ninput"], cfg["nhidden"], cfg["noutput"]
    return (3 if train else 1) * 2 * (4 * H * (D + 1 + H) + C * (H + 1))


def _lstm_ms(cfg: dict, st: dict) -> float:
    """The LSTM's matrix flop at the valid frames (three passes in
    training), its input and weights read and its output written once."""
    D, H = cfg["ninput"], cfg["nhidden"]
    e = 2 if cfg["precision"] == "bf16" else 4
    pk = bounds.peaks("H100")
    flop = (3 if st["train"] else 1) * 2 * st["V"] * (D + 1 + H) * 4 * H
    nbytes = e * (st["V"] * D + (D + 1 + H) * 4 * H + st["B"] * st["T"] * H)
    peak = pk["bf16_flops"] if e == 2 else pk["f32_mma_flops"]
    return bounds.bound(flop, nbytes, peak, pk["hbm_bytes_per_s"])[0]


STEP_BOUNDS = {"lstm": _lstm_ms}
