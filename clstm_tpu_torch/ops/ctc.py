"""CTC as alignment, and greedy decoding (port of clstm_tpu/ops/ctc.py).

Reference: the CTC section of clstm.cc (≈L1100-1300, unverified).
``mktargets`` interleaves blanks into the target string (S = 2N+1 states),
``forward_algorithm`` is a log-space DP over the (time x state) lattice
with transitions {stay, advance-by-one} plus a per-state/per-time skip
penalty used for initialization, ``ctc_align_targets`` combines forward and
backward passes into per-frame aligned posterior targets, and
``trivial_decode`` is the greedy decoder. The reference trains with
``outputs.d = aligned - outputs.v`` (alignment targets, not the textbook CTC
gradient), so the recipe is followed step for step.

``ctc_align_targets_batched`` runs the fused formulation of the JAX
package's TPU branch: the forward DP (K5) and the fused second direction
(K6, ``both`` and its logsumexp over time) through the wrappers of
ops/ctc_kernel.py — CUDA kernels on a card, their plain versions on CPU
tensors. ``fused=False`` runs the scan recipe instead (``_forward_scan``
plus ``_backward_dp``: the flip recipe, or K6b for f32 CUDA tensors unless
``use_kernel=False``), the reference the tests and chip_smoke.py hold the
fused path against. lmatch is a gather, exact in
f32; the aligned targets are an f32 product with the one-hot targets, with
TF32 off (utils/config.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from clstm_tpu_torch.ops.seq import flip_within_length
from clstm_tpu_torch.utils.profiling import span

NEG = -1e30  # log-space "impossible" (finite to keep arithmetic NaN-free)
LO = 1e-5    # probability floor, as in the reference (lo = 1e-5)
SKIP = -5.0  # default skip penalty, as in the reference


def mktargets_ids(classes, S: Optional[int] = None) -> np.ndarray:
    """Interleave CTC blanks (class 0) into a class-id sequence; optionally
    right-pad (or cut) to S states with 0."""
    classes = list(classes)
    ids = np.zeros(2 * len(classes) + 1, dtype=np.int32)
    ids[1::2] = classes
    if S is not None:
        out = np.zeros(S, dtype=np.int32)
        out[: len(ids)] = ids[:S]
        return out
    return ids


def mktargets(classes, nclasses: int) -> np.ndarray:
    """One-hot [2N+1, nclasses] target matrix — the reference's output."""
    ids = mktargets_ids(classes)
    out = np.zeros((len(ids), nclasses), dtype=np.float32)
    out[np.arange(len(ids)), ids] = 1.0
    return out


def _forward_scan(lmatch: torch.Tensor, tvalid: torch.Tensor,
                  skip: float) -> torch.Tensor:
    """Batched log-space forward DP, a loop over T.

    lmatch [B, T, S] log match scores (NEG for invalid states); tvalid
    [B, T] bool (padded frames carry the state through). Returns lr
    [B, T, S], log-alpha after each frame:
      v0[j] = skip * j
      for each frame i: w = roll(v, 1); w[0] = skip * i
                        v = logaddexp(v + lmatch[i], w + lmatch[i])
    """
    B, T, S = lmatch.shape
    v = skip * torch.arange(S, dtype=lmatch.dtype, device=lmatch.device)
    v = v[None, :].expand(B, S)
    out = []
    for i in range(T):
        lm = lmatch[:, i]
        w = torch.roll(v, 1, dims=1)
        w[:, 0] = skip * i
        v_new = torch.logaddexp(v + lm, w + lm)
        v = torch.where(tvalid[:, i, None], v_new, v)
        out.append(v)
    return torch.stack(out, dim=1)


def forward_algorithm(lmatch: torch.Tensor, skip: float = SKIP) -> torch.Tensor:
    """Single-example [T, S] forward DP (reference-shaped API)."""
    tvalid = torch.ones((1, lmatch.shape[0]), dtype=torch.bool,
                        device=lmatch.device)
    return _forward_scan(lmatch[None], tvalid, skip)[0]


def ctc_forward_plain(lmatch: torch.Tensor, lengths: torch.Tensor,
                      skip: float = SKIP) -> torch.Tensor:
    """K5's plain version: the forward DP with frame validity from
    ``lengths`` [B] (frames t >= len carry the state through)."""
    T = lmatch.shape[1]
    tvalid = torch.arange(T, device=lmatch.device)[None, :] < lengths[:, None]
    return _forward_scan(lmatch, tvalid, skip)


def ctc_both_plain(lmatch: torch.Tensor, lr: torch.Tensor,
                   lengths: torch.Tensor, target_lengths: torch.Tensor,
                   skip: float = SKIP):
    """K6's plain version: the second DP direction walked backward in time
    without flips (pallas_ctc.py::_bwd_kernel, fuse_both=True):
      u_init[s] = skip·(tlen-1-s), NEG for s >= tlen;
      u_t = logaddexp(u_{t+1} + lm_t, w + lm_t), w[s] = u_{t+1}[s+1]
      (NEG past the last state), the boundary column s = tlen-1 set to
      skip·(len-1-t); frames t >= len carry u through.
    Returns both = lr + u (NEG on frames t >= len) [B, T, S] and
    lse [B, S] = logsumexp over t of both, by a running max/scaled-sum pair.
    """
    B, T, S = lmatch.shape
    dt, dev = lmatch.dtype, lmatch.device
    L = lengths.to(dev).clamp(0, T)[:, None]
    TL = target_lengths.to(dev)[:, None]
    col = torch.arange(S, device=dev)[None, :]
    neg = torch.full((), NEG, dtype=dt, device=dev)
    u = torch.where(col < TL, (skip * (TL - 1 - col)).to(dt), neg)
    bcol = col == TL - 1
    m = torch.full((B, S), NEG, dtype=dt, device=dev)
    a = torch.zeros((B, S), dtype=dt, device=dev)
    tail = torch.full((B, 1), NEG, dtype=dt, device=dev)
    both = torch.empty((B, T, S), dtype=dt, device=dev)
    for t in range(T - 1, -1, -1):
        valid = t < L
        w = torch.cat([u[:, 1:], tail], dim=1)
        w = torch.where(bcol, (skip * (L - 1 - t)).to(dt), w)
        lm = lmatch[:, t]
        u = torch.where(valid, torch.logaddexp(u + lm, w + lm), u)
        bo = torch.where(valid, lr[:, t] + u, neg)
        both[:, t] = bo
        mx = torch.maximum(m, bo)
        a = a * torch.exp(m - mx) + torch.exp(bo - mx)
        m = mx
    return both, m + torch.log(torch.clamp(a, min=1e-30))


def _backward_dp(lmatch: torch.Tensor, tvalid: torch.Tensor,
                 lengths: torch.Tensor, target_lengths: torch.Tensor,
                 skip: float,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """The second DP direction. ``use_kernel`` mirrors the JAX package's
    ``use_pallas``: with None, K6b (ops/ctc_kernel.py::ctc_backward) runs
    exactly for float32 CUDA tensors; otherwise, and in float64, the flip
    recipe runs: flip time and states within their lengths, run the
    forward DP, flip back. The two agree on valid cells (t < len,
    s < tlen) only."""
    if use_kernel is None:
        use_kernel = lmatch.is_cuda and lmatch.dtype == torch.float32
    if use_kernel:
        from clstm_tpu_torch.ops.ctc_kernel import ctc_backward
        return ctc_backward(lmatch.contiguous(), lengths, target_lengths, skip)
    lm_rev = flip_within_length(lmatch, lengths)
    lm_rev = flip_within_length(lm_rev.transpose(1, 2), target_lengths)
    rl = _forward_scan(lm_rev.transpose(1, 2), tvalid, skip)
    rl = flip_within_length(rl, lengths)
    return flip_within_length(rl.transpose(1, 2),
                              target_lengths).transpose(1, 2)


def ctc_backward_plain(lmatch: torch.Tensor, lengths: torch.Tensor,
                       target_lengths: torch.Tensor,
                       skip: float = SKIP) -> torch.Tensor:
    """K6b's plain version: the flip recipe of ``_backward_dp``."""
    T = lmatch.shape[1]
    tvalid = torch.arange(T, device=lmatch.device)[None, :] < lengths[:, None]
    return _backward_dp(lmatch, tvalid, lengths, target_lengths, skip,
                        use_kernel=False)


def ctc_align_targets_batched(
    probs: torch.Tensor,
    target_ids: torch.Tensor,
    *,
    lengths: Optional[torch.Tensor] = None,
    target_lengths: Optional[torch.Tensor] = None,
    skip: float = SKIP,
    lo: float = LO,
    fused: bool = True,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Batched CTC alignment: per-frame aligned posterior targets.

    probs [B, T, C] posteriors; target_ids [B, S] blank-interleaved class
    ids (mktargets_ids), zero-padded beyond each row's true state count;
    lengths [B] true frame counts and target_lengths [B] true state counts
    (None: all valid), int32 on the device of ``probs``.

    Returns aligned [B, T, C] (rows of padded frames are uniform: mask them
    in the loss). The recipe, step for step:
      outputs = max(lo, probs); outputs /= rowsum
      lmatch = log(outputs[target_ids])   (NEG on invalid states)
      both = forward(lmatch) + backward(lmatch); epath = exp(both) normalized
      over time per state
      aligned = max(lo, epath @ onehot(targets)); normalized over classes
    ``fused=True`` computes ``both`` and its logsumexp with K5 and K6
    (ops/ctc_kernel.py); ``fused=False`` runs the scan recipe, in float64
    when ``probs`` is float64, with its second direction dispatched by
    ``use_kernel`` (``_backward_dp``: K6b for f32 CUDA tensors unless
    False).
    """
    with span("clstm.ctc"):
        B, T, C = probs.shape
        S = target_ids.shape[1]
        dev = probs.device
        dt = torch.float64 if probs.dtype == torch.float64 else torch.float32
        probs = probs.to(dt)
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
        if target_lengths is None:
            target_lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        tvalid = torch.arange(T, device=dev)[None, :] < lengths[:, None]
        svalid = torch.arange(S, device=dev)[None, :] < target_lengths[:, None]

        out = torch.clamp(probs, min=lo)
        out = out / out.sum(dim=2, keepdim=True)
        idx = target_ids.long()
        gathered = torch.gather(out, 2, idx[:, None, :].expand(B, T, S))
        lmatch = torch.where(svalid[:, None, :], torch.log(gathered),
                             torch.full((), NEG, dtype=dt, device=dev))

        if fused:
            # Imported here: ops/ctc_kernel.py imports this module's plain
            # versions.
            from clstm_tpu_torch.ops.ctc_kernel import ctc_both, ctc_forward
            lmatch = lmatch.contiguous()
            lr = ctc_forward(lmatch, lengths, skip)
            both, lse = ctc_both(lmatch, lr, lengths, target_lengths, skip)
            # All-NEG (t, s) cells (invalid states, padded frames) carry
            # exactly zero path mass.
            epath = torch.where(both > 0.5 * NEG,
                                torch.exp(both - lse[:, None, :]),
                                torch.zeros((), dtype=dt, device=dev))
        else:
            lr = _forward_scan(lmatch, tvalid, skip)
            rl = _backward_dp(lmatch, tvalid, lengths, target_lengths, skip,
                              use_kernel)
            neg = torch.full((), NEG, dtype=dt, device=dev)
            both = torch.where(tvalid[:, :, None], lr + rl, neg)
            both = torch.where(svalid[:, None, :], both, neg)
            m = both.amax(dim=(1, 2), keepdim=True)
            epath = torch.exp(both - m)
            col = epath.sum(dim=1, keepdim=True)
            epath = epath / torch.where(col == 0.0,
                                        torch.full_like(col, 1e-9), col)

        onehot = (torch.nn.functional.one_hot(idx, C).to(dt)
                  * svalid[:, :, None])
        aligned = torch.bmm(epath, onehot)
        aligned = torch.clamp(aligned, min=lo)
        return aligned / aligned.sum(dim=2, keepdim=True)


def ctc_align_targets(probs: torch.Tensor, targets: torch.Tensor, *,
                      skip: float = SKIP, lo: float = LO) -> torch.Tensor:
    """Single-example reference-shaped API: probs [T, C], one-hot targets
    [S, C] (as ``mktargets`` makes them) -> aligned [T, C]."""
    ids = torch.argmax(torch.as_tensor(targets), dim=1).to(torch.int32)
    return ctc_align_targets_batched(probs[None], ids[None].to(probs.device),
                                     skip=skip, lo=lo)[0]


def greedy_frames(probs: torch.Tensor) -> tuple:
    """Device-side half of decoding: probs [..., T, C] -> (ids [..., T],
    vals [..., T]), the per-frame argmax (first index on ties) and its
    probability."""
    ids = torch.argmax(probs, dim=-1)
    vals = torch.gather(probs, -1, ids.unsqueeze(-1)).squeeze(-1)
    return ids, vals


def trivial_decode(probs, length: Optional[int] = None,
                   return_positions: bool = False):
    """Greedy CTC decode of one line, reference semantics: within each
    maximal run delimited by blank-argmax frames, emit the class with the
    highest frame probability and its frame index.

    Accepts [T, C] probabilities (numpy or torch)."""
    p = probs.detach().cpu().numpy() if torch.is_tensor(probs) else np.asarray(probs)
    if length is not None:
        p = p[:length]
    return decode_frames(p.argmax(axis=1), p.max(axis=1), return_positions)


def decode_frames(ids, vals, return_positions: bool = False):
    """Host-side run-collapse over per-frame (argmax id, prob) arrays."""
    with span("clstm.decode"):
        ids = np.asarray(ids)
        vals = np.asarray(vals)
        out, pos = [], []
        mv, mc, mt = 0.0, -1, -1
        for t in range(len(ids)):
            c = int(ids[t])
            if c == 0:
                if mc > 0:
                    out.append(mc)
                    pos.append(mt)
                mv, mc, mt = 0.0, -1, -1
            elif vals[t] > mv:
                mv, mc, mt = float(vals[t]), c, t
        if mc > 0:
            out.append(mc)
            pos.append(mt)
    if return_positions:
        return out, pos
    return out
