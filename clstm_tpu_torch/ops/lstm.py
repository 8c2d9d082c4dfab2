"""Batched LSTM cell, plain PyTorch (port of clstm_tpu/ops/lstm.py).

Fused layout, as in the JAX package: ``Wx [D, 4H]`` (input half),
``Wh [H, 4H]`` (recurrent half), ``b [4H]``, gate order ``(gi, gf, go, ci)``
along the 4H axis — the reference's weight-name order WGI/WGF/WGO/WCI, so
io/proto.py maps slices to the reference gate matrices exactly:
  WGI = concat([b[0:H, None], Wx[:, 0:H].T, Wh[:, 0:H].T], axis=1), etc.

Per step: z = x_t·Wx + b + h·Wh; gi, gf, go sigmoid; ci tanh;
c' = gf·c + gi·ci; h' = tanh(c')·go. Padded steps (t >= len) emit zeros
and carry (h, c) through unchanged.

Both functions are Python loops over T and run on any device. They are the
plain versions the tests and chip_smoke.py hold the kernels against; on a
card the serving path runs ``bidi_lstm_apply``'s kernel instead
(ops/bidi_lstm_kernel.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from clstm_tpu_torch.ops.seq import flip_within_length

def _valid(lengths: Optional[torch.Tensor], B: int, T: int,
           device) -> torch.Tensor:
    """[T, B, 1] bool frame validity."""
    if lengths is None:
        return torch.ones((T, B, 1), dtype=torch.bool, device=device)
    t = torch.arange(T, device=device)
    return (t[:, None] < lengths.to(device)[None, :])[..., None]


def _cell(z: torch.Tensor, c: torch.Tensor, H: int):
    gi = torch.sigmoid(z[..., 0 * H:1 * H])
    gf = torch.sigmoid(z[..., 1 * H:2 * H])
    go = torch.sigmoid(z[..., 2 * H:3 * H])
    ci = torch.tanh(z[..., 3 * H:4 * H])
    c_new = gf * c + gi * ci                   # reference forward_statemem
    h_new = torch.tanh(c_new) * go             # reference forward_nonlingate
    return h_new, c_new


def lstm_apply(params: dict, x: torch.Tensor,
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the LSTM over a right-padded batch: x [B, T, D] -> h [B, T, H]
    (padded steps exactly zero)."""
    Wx, Wh, b = params["Wx"], params["Wh"], params["b"]
    B, T, _ = x.shape
    H = Wh.shape[0]
    xz = torch.matmul(x.float(), Wx) + b       # hoisted input projection
    valid = _valid(lengths, B, T, x.device)
    h = x.new_zeros((B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    outs = []
    for t in range(T):
        h_new, c_new = _cell(xz[:, t] + h @ Wh, c, H)
        v = valid[t]
        c = torch.where(v, c_new, c)
        h = torch.where(v, h_new, h)
        outs.append(torch.where(v, h_new, torch.zeros_like(h_new)))
    return torch.stack(outs, dim=1).to(x.dtype)


def bidi_lstm_apply(params_f: dict, params_r: dict, x: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bidirectional LSTM, both directions stacked on a leading group axis
    in one loop over T.

    Same semantics as
      concat([lstm_apply(params_f, x), flip(lstm_apply(params_r, flip(x)))])
    — the reference's Parallel(NPLSTM, Reversed(NPLSTM)) — with the flip
    taken within each row's length. Returns [B, T, 2H]: forward features
    then backward features. ``lengths`` are clamped to [0, T], as the
    kernel does.
    """
    B, T, _ = x.shape
    H = params_f["Wh"].shape[0]
    if lengths is not None:
        lengths = lengths.to(x.device).clamp(0, T)
    xr = flip_within_length(x, lengths)
    Wx2 = torch.stack([params_f["Wx"], params_r["Wx"]])          # [2, D, 4H]
    b2 = torch.stack([params_f["b"], params_r["b"]])             # [2, 4H]
    Wh2 = torch.stack([params_f["Wh"], params_r["Wh"]])          # [2, H, 4H]
    x2 = torch.stack([x, xr]).float()                            # [2, B, T, D]
    xz = torch.einsum("gbtd,gdo->gbto", x2, Wx2) + b2[:, None, None, :]
    valid = _valid(lengths, B, T, x.device)
    h = x.new_zeros((2, B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    outs = []
    for t in range(T):
        h_new, c_new = _cell(xz[:, :, t] + torch.bmm(h, Wh2), c, H)
        v = valid[t]
        c = torch.where(v, c_new, c)
        h = torch.where(v, h_new, h)
        outs.append(torch.where(v, h_new, torch.zeros_like(h_new)))
    hs = torch.stack(outs, dim=2)                                # [2, B, T, H]
    yr = flip_within_length(hs[1], lengths)
    return torch.cat([hs[0], yr], dim=-1).to(x.dtype)
