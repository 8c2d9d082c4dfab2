"""Batched LSTM cell, plain PyTorch (port of clstm_tpu/ops/lstm.py).

Fused layout, as in the JAX package: ``Wx [D, 4H]`` (input half),
``Wh [H, 4H]`` (recurrent half), ``b [4H]``, gate order ``(gi, gf, go, ci)``
along the 4H axis — the reference's weight-name order WGI/WGF/WGO/WCI, so
io/proto.py maps slices to the reference gate matrices exactly:
  WGI = concat([b[0:H, None], Wx[:, 0:H].T, Wh[:, 0:H].T], axis=1), etc.

Per step: z = x_t·Wx + b + h·Wh; gi, gf, go sigmoid; ci tanh;
c' = gf·c + gi·ci; h' = tanh(c')·go. Padded steps (t >= len) emit zeros
and carry (h, c) through unchanged.

Every function here is plain PyTorch (Python loops over T) and runs on any
device. They are the plain versions the tests and chip_smoke.py hold the
kernels against; on a card the kernels of ops/bidi_lstm_kernel.py run
instead:
  hoisted_projection    the input projection of both directions as
                        one product (not a kernel: XLA's on the TPU);
  bidi_lstm_apply       K3, the inference forward;
  bidi_lstm_fwd_state_plain   K1, the training forward with the state
                              the backward reads;
  bidi_lstm_apply_xz, bidi_lstm_fwd_state_xz_plain
                        K4, the same two on a hoisted projection;
  bidi_lstm_bwd_chain_plain   K2's backward chain (dz per frame);
  bidi_lstm_bwd_reduce_plain  K2's contractions (dWx with the bias row,
                              dWh, dx).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


def hoisted_projection(params_f: dict, params_r: dict,
                       x: torch.Tensor) -> torch.Tensor:
    """The input projection of both directions as one f32 product, taken
    out of the recurrence: xz [B, T, 2, 4H] = x·[Wx_f | Wx_r] + [b_f | b_r],
    in ORIGINAL time order for both directions.

    Counterpart of clstm_tpu/ops/pallas_lstm.py::_proj_stream, which XLA
    computes outside the Pallas kernel; here it is ``torch.addmm`` on
    [B·T, D] x [D, 2·4H]. Strict f32: TF32 is off
    (utils/config.py::torch_device).
    """
    B, T, D = x.shape
    G = params_f["Wh"].shape[1]
    w = torch.cat([params_f["Wx"], params_r["Wx"]], dim=1)       # [D, 8H]
    b = torch.cat([params_f["b"], params_r["b"]])                 # [8H]
    return torch.addmm(b, x.reshape(B * T, D).float(), w).reshape(B, T, 2, G)


def _chain_plain(params_f: dict, params_r: dict, xz: torch.Tensor,
                 lengths: Optional[torch.Tensor], with_state: bool):
    """The recurrence of both directions in one loop over T on a hoisted
    projection xz [B, T, 2, 4H] in original time order; the reverse chain
    reads frame len-1-s at step s. Returns y [B, T, 2H] and, with
    ``with_state``, gates [B, T, 2, 4H] and cell [B, T, 2, H] (else None),
    in original time order and exactly 0 on padded frames. Lengths are
    clamped to [0, T]; padded steps carry (h, c) through unchanged."""
    B, T, _, G = xz.shape
    H = G // 4
    if lengths is not None:
        lengths = lengths.to(xz.device).clamp(0, T)
    xz = _to_dirs(xz, lengths)                                   # [2,B,T,4H]
    Wh2 = torch.stack([params_f["Wh"], params_r["Wh"]])          # [2,H,4H]
    valid = _valid(lengths, B, T, xz.device)
    h = xz.new_zeros((2, B, H))
    c = torch.zeros_like(h)
    hs, gs, cs = [], [], []
    for t in range(T):
        z = xz[:, :, t] + torch.bmm(h, Wh2)
        g = torch.cat([torch.sigmoid(z[..., :3 * H]),
                       torch.tanh(z[..., 3 * H:])], dim=-1)
        c_new = g[..., H:2 * H] * c + g[..., :H] * g[..., 3 * H:]
        h_new = torch.tanh(c_new) * g[..., 2 * H:3 * H]
        v = valid[t]
        c = torch.where(v, c_new, c)
        h = torch.where(v, h_new, h)
        hs.append(torch.where(v, h_new, torch.zeros_like(h_new)))
        if with_state:
            gs.append(torch.where(v, g, torch.zeros_like(g)))
            cs.append(torch.where(v, c_new, torch.zeros_like(c_new)))
    y = _from_dirs(torch.stack(hs, dim=2), lengths).reshape(B, T, 2 * H)
    if not with_state:
        return y, None, None
    return (y, _from_dirs(torch.stack(gs, dim=2), lengths),
            _from_dirs(torch.stack(cs, dim=2), lengths))


def bidi_lstm_apply_xz(params_f: dict, params_r: dict, xz: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4's plain version, inference: the bidirectional recurrence on a
    hoisted projection xz [B, T, 2, 4H] (``hoisted_projection``; original
    time order) -> y [B, T, 2H], forward features then backward features,
    exactly 0 on padded frames. The reverse direction reads frame len-1-s
    at chain step s. Only ``Wh`` of the params is read."""
    return _chain_plain(params_f, params_r, xz, lengths, False)[0]


def bidi_lstm_fwd_state_xz_plain(params_f: dict, params_r: dict,
                                 xz: torch.Tensor,
                                 lengths: Optional[torch.Tensor] = None):
    """K4's plain version, state mode: ``bidi_lstm_apply_xz`` plus the
    state the backward pass reads, with the layout and zeros of
    ``bidi_lstm_fwd_state_plain`` (y [B, T, 2H], gates [B, T, 2, 4H], cell
    [B, T, 2, H])."""
    return _chain_plain(params_f, params_r, xz, lengths, True)


def bidi_lstm_apply(params_f: dict, params_r: dict, x: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bidirectional LSTM, K3's plain version: the hoisted projection, then
    both directions stacked on a leading group axis in one loop over T.

    Same semantics as
      concat([lstm_apply(params_f, x), flip(lstm_apply(params_r, flip(x)))])
    — the reference's Parallel(NPLSTM, Reversed(NPLSTM)) — with the flip
    taken within each row's length. Returns [B, T, 2H]: forward features
    then backward features. ``lengths`` are clamped to [0, T], as the
    kernel does.
    """
    xz = hoisted_projection(params_f, params_r, x)
    return bidi_lstm_apply_xz(params_f, params_r, xz, lengths).to(x.dtype)


def _to_dirs(a: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, T, 2, ...] in original time order -> [2, B, T, ...] in chain
    order (the reverse direction flipped within length)."""
    return torch.stack([a[:, :, 0], flip_within_length(a[:, :, 1], lengths)])


def _from_dirs(a: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverse of ``_to_dirs``."""
    return torch.stack([a[0], flip_within_length(a[1], lengths)], dim=2)


def bidi_lstm_fwd_state_plain(params_f: dict, params_r: dict, x: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None):
    """K1's plain version: ``bidi_lstm_apply`` plus the state the backward
    pass reads, all f32 in ORIGINAL time order per direction:

      y     [B, T, 2H]     the layer output (as bidi_lstm_apply);
      gates [B, T, 2, 4H]  the activated gates (gi, gf, go, ci) of each step;
      cell  [B, T, 2, H]   c after each step.

    Every stream is exactly 0 on padded frames (t >= len). The pre-step
    state is not stored: h_prev and c_prev of a frame are y and cell of the
    frame before it in chain order (t-1 forward, t+1 reverse), 0 at a
    chain's first step.
    """
    return bidi_lstm_fwd_state_xz_plain(
        params_f, params_r, hoisted_projection(params_f, params_r, x), lengths)


def bidi_lstm_bwd_chain_plain(gates: torch.Tensor, cell: torch.Tensor,
                        gy: torch.Tensor, Wh2: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2's backward chain, plain: an explicit loop backward in time, not
    autograd (pallas_lstm.py::_bwd_kernel, L391-430).

    gates, cell: K1's streams; gy [B, T, 2H] the cotangent of y; Wh2
    [2, H, 4H] the recurrent weights of both directions. Per chain step,
    walking each row's valid steps backward:
      dh = gy + Dh;  dc = Dc + dh·go·(1 - tanh²c)
      dz = [dc·ci·gi(1-gi), dc·c_prev·gf(1-gf), dh·tanh(c)·go(1-go),
            dc·gi(1-ci²)]
      Dh = dz·Whᵀ;  Dc = dc·gf
    Returns dz [B, T, 2, 4H] in original time order, exactly 0 on padded
    frames, so padded frames add nothing to any gradient.
    """
    B, T, _, G = gates.shape
    H = G // 4
    if lengths is not None:
        lengths = lengths.to(gates.device).clamp(0, T)
    g_c = _to_dirs(gates, lengths)                              # [2,B,T,4H]
    c_c = _to_dirs(cell, lengths)                               # [2,B,T,H]
    gy_c = _to_dirs(gy.reshape(B, T, 2, H), lengths)            # [2,B,T,H]
    valid = _valid(lengths, B, T, gates.device)
    WhT = Wh2.transpose(1, 2)
    Dh = gates.new_zeros((2, B, H))
    Dc = torch.zeros_like(Dh)
    dzs = [None] * T
    for s in range(T - 1, -1, -1):
        m = valid[s].to(gates.dtype)
        gi, gf, go, ci = g_c[:, :, s].split(H, dim=-1)
        c = c_c[:, :, s]
        cp = c_c[:, :, s - 1] if s > 0 else torch.zeros_like(c)
        tc = torch.tanh(c)
        dh = (gy_c[:, :, s] + Dh) * m
        dc = Dc * m + dh * go * (1.0 - tc * tc)
        dz = torch.cat([dc * ci * gi * (1.0 - gi),
                        dc * cp * gf * (1.0 - gf),
                        dh * tc * go * (1.0 - go),
                        dc * gi * (1.0 - ci * ci)], dim=-1)
        Dh = torch.bmm(dz, WhT)
        Dc = dc * gf
        dzs[s] = dz
    return _from_dirs(torch.stack(dzs, dim=2), lengths)


def bidi_lstm_bwd_reduce_plain(x: torch.Tensor, y: torch.Tensor, dz: torch.Tensor,
                         Wx2: torch.Tensor, need_dx: bool = True):
    """K2's contractions, plain (pallas_lstm.py::_bwd_kernel, L440-463).

    x [B, T, D]; y [B, T, 2H] (K1's output, the source of h_prev); dz
    [B, T, 2, 4H] from the chain; Wx2 [2, D, 4H]. Per direction:
      dW [D+1+H, 4H] = Σ_frames [x | 1 | h_prev]ᵀ · dz
    (rows: dWx, then the bias row db, then dWh), and, with ``need_dx``,
      dx [B, T, D] = Σ_dir dz · Wxᵀ.
    Returns (dW [2, D+1+H, 4H], dx or None).
    """
    B, T, D = x.shape
    H = y.shape[-1] // 2
    h_prev = torch.stack([F.pad(y[:, :-1, :H], (0, 0, 1, 0)),
                          F.pad(y[:, 1:, H:], (0, 0, 0, 1))])   # [2,B,T,H]
    xcat = torch.cat([x.float(), x.new_ones((B, T, 1), dtype=torch.float32)],
                     dim=-1)
    a = torch.cat([xcat.expand(2, B, T, D + 1), h_prev], dim=-1)
    dW = torch.einsum("gbti,btgj->gij", a, dz)
    dx = torch.einsum("btgj,gdj->btd", dz, Wx2) if need_dx else None
    return dW, dx
