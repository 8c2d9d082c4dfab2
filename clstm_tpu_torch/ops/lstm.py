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

``lstm_apply`` and ``bidi_lstm_apply`` also take ``compute_dtype`` (e.g.
torch.bfloat16), the JAX package's scan recipe (clstm_tpu/ops/lstm.py
``compute_dtype``), which no kernel runs: the JAX package routes it to
``lax.scan`` on every backend, and the port to these loops on every device.
Its rounding points are the scan's, and its gradient is the one ``jax.grad``
takes through the scan: the hoisted x·Wx and each step's h·Wh take operands
rounded to ``compute_dtype`` with f32 accumulation, the f32 bias is added
after; the gates, c, h and y stay f32, and y comes back in x's type. Wh is
rounded once, outside the loop, and read as f32 at each step, so autograd
sums its gradient in ``compute_dtype`` over the steps (the scan's transpose
carries the cotangent of a ``compute_dtype`` constant in that type); the
f32 cotangent of each rounded h is rounded to ``compute_dtype`` on its way
back into the f32 chain (the transpose of the cast); dWx and dx are f32
products rounded once; db stays f32. A third mode beside strict f32 and
``xz_bf16``, and never combined with the latter.

Each bidi function takes ``xz_bf16``, the JAX package's production mode
(clstm_tpu/ops/pallas_lstm.py, ``bidi_lstm_pallas(..., xz_bf16=True)``),
with its rounding points: bf16 operands before every product ([x | 1],
W_in with its bias row, Wh, h before each recurrent product; in the
backward dz, x and h_prev), every product and the gate math, carries and
backward chain in f32, and bf16 on the way out (the hoisted projection, y,
the stored cell, dz, each direction's half of dx; the stored gates stay f32,
as the JAX package recomputes them in f32). The in-kernel
projection is not rounded. A bf16 product is taken as the f32 product of
bf16-rounded operands, which is exact, so it is bf16 operands with f32
accumulation. The arithmetic runs in float64 instead of f32 when the
weights are float64 (the distance reference of chip_smoke.py), with every
rounding point in place; outputs rounded to bf16 are then kept in float64.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from clstm_tpu_torch.ops.seq import flip_within_length


GATE_ORDER = ("GI", "GF", "GO", "CI")


def lstm_init(generator: torch.Generator, ninput: int, nhidden: int, *,
              scale: float = 0.01, dtype=torch.float32) -> dict:
    """Fused LSTM parameters {"Wx": [D, 4H], "Wh": [H, 4H], "b": [4H]},
    each uniform in [-scale, scale] (reference init over the whole
    (nhidden, 1+ninput+nhidden) matrix, attr ``initial`` / rinit "unif"),
    drawn from ``generator`` (a CPU generator) in that order, as
    models/spec.py's NPLSTM layer draws its weights. The draws are torch's,
    not jax.random's: weights cross between the packages by conversion
    (convert.py), not by seed."""
    def draw(*shape):
        return torch.empty(shape, dtype=dtype).uniform_(-scale, scale,
                                                        generator=generator)
    return {"Wx": draw(ninput, 4 * nhidden), "Wh": draw(nhidden, 4 * nhidden),
            "b": draw(4 * nhidden)}


def _cast(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``t`` as an operand of a product under ``compute_dtype``: rounded to
    it and taken as f32, so the product is the f32-accumulated product of
    the rounded operands (exact for bf16 operands). Its gradient is the f32
    cotangent rounded to ``compute_dtype`` and taken back to t's type."""
    return t.to(compute_dtype).float()


def _ctype(w: torch.Tensor) -> torch.dtype:
    """The arithmetic type: float64 for float64 weights, else f32."""
    return torch.float64 if w.dtype == torch.float64 else torch.float32


def _op(t: torch.Tensor, ct: torch.dtype, bf16: bool) -> torch.Tensor:
    """``t`` as an operand of a product in type ``ct``: rounded to bf16
    first in the bf16 mode."""
    return (t.to(torch.bfloat16) if bf16 else t).to(ct)


def _out(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A stream on its way out: bf16 in the bf16 mode (float64 arithmetic
    keeps the rounded values in float64)."""
    if not bf16:
        return t
    r = t.to(torch.bfloat16)
    return r.to(t.dtype) if t.dtype == torch.float64 else r


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
               lengths: Optional[torch.Tensor] = None, *,
               compute_dtype=None) -> torch.Tensor:
    """Run the LSTM over a right-padded batch: x [B, T, D] -> h [B, T, H]
    (padded steps exactly zero), in x's type. ``compute_dtype``: the scan
    recipe's rounding points (module docstring); None is strict f32."""
    Wx, Wh, b = params["Wx"], params["Wh"], params["b"]
    B, T, _ = x.shape
    H = Wh.shape[0]
    cd = compute_dtype
    if cd is None:
        xz = torch.matmul(x.float(), Wx) + b   # hoisted input projection
    else:
        xz = torch.matmul(_cast(x, cd), _cast(Wx, cd)) + b.float()
        Wh = Wh.to(cd)       # rounded once: its gradient sums in cd
    valid = _valid(lengths, B, T, x.device)
    # One view a step: autograd then stacks the steps' cotangents once,
    # where indexing xz[:, t] adds each into a zero tensor of xz's size.
    xzs = xz.unbind(1)
    h = x.new_zeros((B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    outs = []
    for t in range(T):
        hw = h @ Wh if cd is None else _cast(h, cd) @ Wh.float()
        h_new, c_new = _cell(xzs[t] + hw, c, H)
        v = valid[t]
        c = torch.where(v, c_new, c)
        h = torch.where(v, h_new, h)
        outs.append(torch.where(v, h_new, torch.zeros_like(h_new)))
    return torch.stack(outs, dim=1).to(x.dtype)


def _projection(params_f: dict, params_r: dict, x: torch.Tensor,
                bf16: bool) -> torch.Tensor:
    """x·[Wx_f | Wx_r] + [b_f | b_r] -> [B, T, 2, 4H], in the arithmetic
    type of the weights (bf16 operands in the bf16 mode, the result not
    rounded)."""
    B, T, D = x.shape
    G = params_f["Wh"].shape[1]
    w = torch.cat([params_f["Wx"], params_r["Wx"]], dim=1)       # [D, 8H]
    b = torch.cat([params_f["b"], params_r["b"]])                 # [8H]
    ct = _ctype(w)
    return torch.addmm(_op(b, ct, bf16), _op(x.reshape(B * T, D), ct, bf16),
                       _op(w, ct, bf16)).reshape(B, T, 2, G)


def hoisted_projection(params_f: dict, params_r: dict, x: torch.Tensor,
                       xz_bf16: bool = False) -> torch.Tensor:
    """The input projection of both directions as one product, taken out
    of the recurrence: xz [B, T, 2, 4H] = x·[Wx_f | Wx_r] + [b_f | b_r],
    in ORIGINAL time order for both directions.

    Counterpart of clstm_tpu/ops/pallas_lstm.py::_proj_stream, which XLA
    computes outside the Pallas kernel; here it is ``torch.addmm`` on
    [B·T, D] x [D, 2·4H]. Strict f32: TF32 is off
    (utils/config.py::torch_device). With ``xz_bf16`` the operands (the
    bias too, a row of W_in in the JAX package) are rounded to bf16, the
    product accumulates in f32 and the result is rounded to bf16. The
    product is taken as the f32 product of the rounded operands on every
    device: cuBLAS's bf16 kernels wait for the card at the first use of
    each kernel in a process, which a new batch shape brings
    (scripts/torch_blas_wait_probe.py).
    """
    return _out(_projection(params_f, params_r, x, xz_bf16), xz_bf16)


def _chain_plain(params_f: dict, params_r: dict, xz: torch.Tensor,
                 lengths: Optional[torch.Tensor], with_state: bool,
                 bf16: bool = False):
    """The recurrence of both directions in one loop over T on a hoisted
    projection xz [B, T, 2, 4H] in original time order; the reverse chain
    reads frame len-1-s at step s. Returns y [B, T, 2H] and, with
    ``with_state``, gates [B, T, 2, 4H] and cell [B, T, 2, H] (else None),
    in original time order and exactly 0 on padded frames. Lengths are
    clamped to [0, T]; padded steps carry (h, c) through unchanged. With
    ``bf16``: Wh and h rounded before each product, y and cell rounded to
    bf16; the gates stay in the arithmetic type (JAX recomputes them in f32
    in its backward; rounded, they moved the gradients ~1e-2 of their max
    from the JAX package's, tests/test_torch_bf16.py)."""
    B, T, _, G = xz.shape
    H = G // 4
    if lengths is not None:
        lengths = lengths.to(xz.device).clamp(0, T)
    Wh2 = torch.stack([params_f["Wh"], params_r["Wh"]])          # [2,H,4H]
    ct = _ctype(Wh2)
    Wh2 = _op(Wh2, ct, bf16)
    xz = _to_dirs(xz.to(ct), lengths)                            # [2,B,T,4H]
    valid = _valid(lengths, B, T, xz.device)
    h = xz.new_zeros((2, B, H))
    c = torch.zeros_like(h)
    hs, gs, cs = [], [], []
    for t in range(T):
        z = xz[:, :, t] + torch.bmm(_op(h, ct, bf16), Wh2)
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
    y = _out(_from_dirs(torch.stack(hs, dim=2), lengths).reshape(B, T, 2 * H),
             bf16)
    if not with_state:
        return y, None, None
    return (y, _from_dirs(torch.stack(gs, dim=2), lengths),
            _out(_from_dirs(torch.stack(cs, dim=2), lengths), bf16))


def bidi_lstm_apply_xz(params_f: dict, params_r: dict, xz: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None,
                       xz_bf16: bool = False) -> torch.Tensor:
    """K4's plain version, inference: the bidirectional recurrence on a
    hoisted projection xz [B, T, 2, 4H] (``hoisted_projection``; original
    time order) -> y [B, T, 2H], forward features then backward features,
    exactly 0 on padded frames. The reverse direction reads frame len-1-s
    at chain step s. Only ``Wh`` of the params is read. ``xz_bf16``: xz is
    the rounded bf16 product and y comes out in bf16."""
    return _chain_plain(params_f, params_r, xz, lengths, False, xz_bf16)[0]


def bidi_lstm_fwd_state_xz_plain(params_f: dict, params_r: dict,
                                 xz: torch.Tensor,
                                 lengths: Optional[torch.Tensor] = None,
                                 xz_bf16: bool = False):
    """K4's plain version, state mode: ``bidi_lstm_apply_xz`` plus the
    state the backward pass reads, with the layout and zeros of
    ``bidi_lstm_fwd_state_plain`` (y [B, T, 2H], gates [B, T, 2, 4H], cell
    [B, T, 2, H]; y and cell bf16 with ``xz_bf16``)."""
    return _chain_plain(params_f, params_r, xz, lengths, True, xz_bf16)


def bidi_lstm_apply(params_f: dict, params_r: dict, x: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    xz_bf16: bool = False, *,
                    compute_dtype=None) -> torch.Tensor:
    """Bidirectional LSTM, K3's plain version: the hoisted projection, then
    both directions stacked on a leading group axis in one loop over T.

    Same semantics as
      concat([lstm_apply(params_f, x), flip(lstm_apply(params_r, flip(x)))])
    — the reference's Parallel(NPLSTM, Reversed(NPLSTM)) — with the flip
    taken within each row's length. Returns [B, T, 2H]: forward features
    then backward features. ``lengths`` are clamped to [0, T], as the
    kernel does. With ``xz_bf16`` the projection takes bf16 operands and
    is not rounded (it stays in the kernel, as on the TPU), and y is bf16.
    With ``compute_dtype`` it is the JAX package's ``bidi_lstm_apply``
    with that argument, the scan recipe (``_bidi_scan``), which no kernel
    runs; it is never combined with ``xz_bf16``.
    """
    if compute_dtype is not None:
        if xz_bf16:
            raise ValueError("compute_dtype and xz_bf16 are two precision "
                             "modes; the JAX package never combines them")
        return _bidi_scan(params_f, params_r, x, lengths, compute_dtype)
    if xz_bf16:
        return _chain_plain(params_f, params_r,
                            _projection(params_f, params_r, x, True),
                            lengths, False, True)[0]
    xz = hoisted_projection(params_f, params_r, x)
    return bidi_lstm_apply_xz(params_f, params_r, xz, lengths).to(x.dtype)


def _bidi_scan(params_f: dict, params_r: dict, x: torch.Tensor,
               lengths: Optional[torch.Tensor], cd) -> torch.Tensor:
    """clstm_tpu/ops/lstm.py::bidi_lstm_apply under ``compute_dtype`` cd,
    step for step: both directions' projections as one batched product of
    the stacked [x, flip(x)] and [Wx_f, Wx_r] rounded to cd, plus the f32
    bias; [Wh_f, Wh_r] rounded to cd once; per step the batched h·Wh of
    the rounded h, f32 gates and carries; y in x's type. Autograd through
    these casts is the scan's gradient (module docstring)."""
    B, T, _ = x.shape
    H = params_f["Wh"].shape[0]
    x2 = _cast(torch.stack([x, flip_within_length(x, lengths)]), cd)
    Wx2 = _cast(torch.stack([params_f["Wx"], params_r["Wx"]]), cd)
    b2 = torch.stack([params_f["b"], params_r["b"]]).float()
    xz = torch.einsum("gbtd,gdo->gbto", x2, Wx2) + b2[:, None, None, :]
    Wh2 = torch.stack([params_f["Wh"], params_r["Wh"]]).to(cd)
    valid = _valid(lengths, B, T, x.device)                      # [T,B,1]
    xzs = xz.unbind(2)             # one view a step, as in lstm_apply
    h = x.new_zeros((2, B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    outs = []
    for t in range(T):
        z = xzs[t] + torch.bmm(_cast(h, cd), Wh2.float())
        h_new, c_new = _cell(z, c, H)
        v = valid[t]
        c = torch.where(v, c_new, c)
        h = torch.where(v, h_new, h)
        outs.append(torch.where(v, h_new, torch.zeros_like(h_new)))
    hs = torch.stack(outs, dim=2)                                # [2,B,T,H]
    return torch.cat([hs[0], flip_within_length(hs[1], lengths)],
                     dim=-1).to(x.dtype)


def _to_dirs(a: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, T, 2, ...] in original time order -> [2, B, T, ...] in chain
    order (the reverse direction flipped within length)."""
    return torch.stack([a[:, :, 0], flip_within_length(a[:, :, 1], lengths)])


def _from_dirs(a: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverse of ``_to_dirs``."""
    return torch.stack([a[0], flip_within_length(a[1], lengths)], dim=2)


def bidi_lstm_fwd_state_plain(params_f: dict, params_r: dict, x: torch.Tensor,
                              lengths: Optional[torch.Tensor] = None,
                              xz_bf16: bool = False):
    """K1's plain version: ``bidi_lstm_apply`` plus the state the backward
    pass reads, all f32 in ORIGINAL time order per direction:

      y     [B, T, 2H]     the layer output (as bidi_lstm_apply);
      gates [B, T, 2, 4H]  the activated gates (gi, gf, go, ci) of each step;
      cell  [B, T, 2, H]   c after each step.

    Every stream is exactly 0 on padded frames (t >= len). The pre-step
    state is not stored: h_prev and c_prev of a frame are y and cell of the
    frame before it in chain order (t-1 forward, t+1 reverse), 0 at a
    chain's first step. With ``xz_bf16`` y and cell are bf16, as the JAX
    package stores its pre-step state (``seq_dtype``); the gates, which it
    recomputes in f32, stay f32.
    """
    return _chain_plain(params_f, params_r,
                        _projection(params_f, params_r, x, xz_bf16),
                        lengths, True, xz_bf16)


def bidi_lstm_bwd_chain_plain(gates: torch.Tensor, cell: torch.Tensor,
                              gy: torch.Tensor, Wh2: torch.Tensor,
                              lengths: Optional[torch.Tensor] = None,
                              xz_bf16: bool = False) -> torch.Tensor:
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
    frames, so padded frames add nothing to any gradient. With ``xz_bf16``
    cell and gy come in bf16 (the gates in f32), the chain stays f32
    (pallas_lstm.py L385-388), dz and Wh are rounded to bf16 for
    Dh = dz·Whᵀ and dz is stored in bf16.
    """
    B, T, _, G = gates.shape
    H = G // 4
    if lengths is not None:
        lengths = lengths.to(gates.device).clamp(0, T)
    ct = _ctype(Wh2)
    g_c = _to_dirs(gates.to(ct), lengths)                       # [2,B,T,4H]
    c_c = _to_dirs(cell.to(ct), lengths)                        # [2,B,T,H]
    gy_c = _to_dirs(_op(gy, ct, xz_bf16).reshape(B, T, 2, H), lengths)
    valid = _valid(lengths, B, T, gates.device)
    WhT = _op(Wh2.transpose(1, 2), ct, xz_bf16)
    Dh = g_c.new_zeros((2, B, H))
    Dc = torch.zeros_like(Dh)
    dzs = [None] * T
    for s in range(T - 1, -1, -1):
        m = valid[s].to(ct)
        gi, gf, go, ci = g_c[:, :, s].split(H, dim=-1)
        c = c_c[:, :, s]
        cp = c_c[:, :, s - 1] if s > 0 else torch.zeros_like(c)
        tc = torch.tanh(c)
        dh = (gy_c[:, :, s] + Dh) * m
        dc = Dc * m + dh * go * (1.0 - tc * tc)
        dz = _op(torch.cat([dc * ci * gi * (1.0 - gi),
                            dc * cp * gf * (1.0 - gf),
                            dh * tc * go * (1.0 - go),
                            dc * gi * (1.0 - ci * ci)], dim=-1), ct, xz_bf16)
        Dh = torch.bmm(dz, WhT)
        Dc = dc * gf
        dzs[s] = dz
    return _out(_from_dirs(torch.stack(dzs, dim=2), lengths), xz_bf16)


def bidi_lstm_bwd_reduce_plain(x: torch.Tensor, y: torch.Tensor,
                               dz: torch.Tensor, Wx2: torch.Tensor,
                               need_dx: bool = True, xz_bf16: bool = False):
    """K2's contractions, plain (pallas_lstm.py::_bwd_kernel, L440-463).

    x [B, T, D]; y [B, T, 2H] (K1's output, the source of h_prev); dz
    [B, T, 2, 4H] from the chain; Wx2 [2, D, 4H]. Per direction:
      dW [D+1+H, 4H] = Σ_frames [x | 1 | h_prev]ᵀ · dz
    (rows: dWx, then the bias row db, then dWh), and, with ``need_dx``,
      dx [B, T, D] = Σ_dir dz · Wxᵀ.
    Returns (dW [2, D+1+H, 4H], dx or None). With ``xz_bf16`` every operand
    is bf16 (x rounded), dW stays f32, and each direction's half of dx is
    rounded to bf16 before the two are added (pallas_lstm.py L913-917); dx
    comes out in x's type.
    """
    B, T, D = x.shape
    H = y.shape[-1] // 2
    ct = _ctype(Wx2)
    y, dz = _op(y, ct, xz_bf16), _op(dz, ct, xz_bf16)
    h_prev = torch.stack([F.pad(y[:, :-1, :H], (0, 0, 1, 0)),
                          F.pad(y[:, 1:, H:], (0, 0, 0, 1))])   # [2,B,T,H]
    xcat = torch.cat([_op(x, ct, xz_bf16), y.new_ones((B, T, 1))], dim=-1)
    a = torch.cat([xcat.expand(2, B, T, D + 1), h_prev], dim=-1)
    dW = torch.einsum("gbti,btgj->gij", a, dz)
    if not need_dx:
        return dW, None
    if not xz_bf16:
        return dW, torch.einsum("btgj,gdj->btd", dz, Wx2.to(ct))
    half = torch.einsum("btgj,gdj->gbtd", dz, _op(Wx2, ct, True))
    dx = _op(half[0], ct, True) + _op(half[1], ct, True)
    return dW, dx.to(x.dtype)
