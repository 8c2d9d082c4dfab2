"""CTC as alignment, clstm's recipe, in plain PyTorch: the per-frame
targets a training step pulls the outputs toward.

  out = max(lo, probs), normalised over classes
  lmatch[t, s] = log out[t, target[s]]     (targets blank-interleaved)
  forward DP:  v0[s] = skip·s;  per valid frame t: w = v shifted one state
               right, w[0] = skip·t;  v = logaddexp(v + lm_t, w + lm_t)
  backward DP: the forward DP on the lattice reversed in time and states
               (each within its length)
  both = forward + backward; epath = exp(both) normalised over time per
  state; aligned = max(lo, epath · onehot(targets)), normalised over
  classes.
Frames past a row's length carry the DP state and take no part; states
past its target length are impossible (log-probability -1e30).
"""

from __future__ import annotations

import torch

NEG = -1e30
LO = 1e-5
SKIP = -5.0


def _forward(lm: torch.Tensor, tvalid: torch.Tensor) -> torch.Tensor:
    B, T, S = lm.shape
    v = (SKIP * torch.arange(S, dtype=lm.dtype, device=lm.device))[None, :]
    v = v.expand(B, S)
    out = []
    for t in range(T):
        w = torch.roll(v, 1, dims=1).clone()
        w[:, 0] = SKIP * t
        v = torch.where(tvalid[:, t, None],
                        torch.logaddexp(v + lm[:, t], w + lm[:, t]), v)
        out.append(v)
    return torch.stack(out, dim=1)


def _flip(x: torch.Tensor, lengths: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    j = torch.arange(n, device=x.device)
    L = lengths.to(x.device).long()[:, None]
    idx = torch.where(j[None, :] < L, L - 1 - j[None, :], j[None, :])
    shape = [x.shape[0], 1, 1]
    shape[dim] = n
    return torch.gather(x, dim, idx.reshape(shape).expand(x.shape))


def align(probs: torch.Tensor, targets: torch.Tensor, lengths: torch.Tensor,
          tlens: torch.Tensor) -> torch.Tensor:
    """probs [B, T, C], targets [B, S] blank-interleaved ids, lengths [B],
    tlens [B] -> aligned targets [B, T, C] (padded frames: uniform rows)."""
    B, T, C = probs.shape
    S = targets.shape[1]
    dev = probs.device
    tvalid = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    svalid = torch.arange(S, device=dev)[None, :] < tlens[:, None]
    out = probs.float().clamp(min=LO)
    out = out / out.sum(dim=2, keepdim=True)
    idx = targets.long()
    lm = torch.where(svalid[:, None, :],
                     torch.log(torch.gather(out, 2,
                                            idx[:, None, :].expand(B, T, S))),
                     torch.full((), NEG, device=dev))
    lr = _forward(lm, tvalid)
    rev = _flip(_flip(lm, lengths, 1), tlens, 2)
    rl = _flip(_flip(_forward(rev, tvalid), lengths, 1), tlens, 2)
    neg = torch.full((), NEG, device=dev)
    both = torch.where(tvalid[:, :, None] & svalid[:, None, :], lr + rl, neg)
    lse = torch.logsumexp(both, dim=1, keepdim=True)
    epath = torch.where(both > 0.5 * NEG, torch.exp(both - lse),
                        torch.zeros((), device=dev))
    onehot = torch.nn.functional.one_hot(idx, C).float() * svalid[:, :, None]
    aligned = torch.bmm(epath, onehot).clamp(min=LO)
    return aligned / aligned.sum(dim=2, keepdim=True)
