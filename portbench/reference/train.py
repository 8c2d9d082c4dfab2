"""The reference training step and the numbers that judge the program's
first steps against it.

The step is clstm's: the net's logits, the CTC alignment of the detached
posteriors, the loss -Σ aligned·log_softmax(logits) over the valid frames
(whose logit gradient is probs - aligned, the delta clstm injects), summed
over the lines and divided by the batch's rows (normalization "batch"), and
heavy-ball SGD: v = g + momentum·v; p -= lr·v.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from portbench.reference import ctc, net

# A leaf whose reference gradient is under this share of the median leaf's
# moves under the update by round-off alone: left out of the change.
STILL_LEAF = 1e-3


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


def targets_of(texts: list, device):
    """Class-id lists -> (blank-interleaved targets [B, S], their lengths)."""
    S = max(2 * len(t) + 1 for t in texts)
    tg = np.zeros((len(texts), S), np.int64)
    tl = np.zeros(len(texts), np.int64)
    for i, t in enumerate(texts):
        tg[i, 1:2 * len(t):2] = t
        tl[i] = 2 * len(t) + 1
    return torch.as_tensor(tg, device=device), torch.as_tensor(tl,
                                                               device=device)


def loss(weights: list, x, lengths, targets, tlens, rows: int,
         rounding: str = "f32") -> torch.Tensor:
    """The step's loss on a batch of ``rows`` rows (rows past x's are
    padding, of length 0)."""
    lg = net.logits(weights, x, lengths, rounding)
    with torch.no_grad():
        aligned = ctc.align(torch.softmax(lg.detach(), -1), targets, lengths,
                            tlens)
    T = x.shape[1]
    mask = (torch.arange(T, device=x.device)[None, :]
            < lengths[:, None]).float()
    per_line = -(aligned * torch.log_softmax(lg, -1)).sum(-1)
    return (per_line * mask).sum() / rows


def steps(weights: list, batches: list, lr: float, momentum: float,
          rounding: str = "f32", fault: str = "") -> dict:
    """Train a copy of ``weights`` on ``batches`` (each {"x", "lengths",
    "texts", "rows"}) -> {"losses": [...], "grad1": {leaf: g of step 1},
    "change": {leaf: p_end - p_0}}. ``fault`` plants one of the faults a
    program can have, for the controls: "frozen" (the state is returned
    unchanged), "half" (half of each batch left out, the mean taken over
    the rest)."""
    net.set_strict_f32()
    ws = [{k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
          for w in weights]
    params = [p for w in ws for p in w.values()]
    vel = [torch.zeros_like(p) for p in params]
    p0 = leaves([{k: v.detach().clone() for k, v in w.items()} for w in ws])
    losses, grad1 = [], None
    for k, b in enumerate(batches):
        x, L, texts, rows = b["x"], b["lengths"], b["texts"], b["rows"]
        if fault == "half":
            n = len(texts) // 2
            x, L, texts, rows = x[:n], L[:n], texts[:n], max(rows // 2, 1)
        tg, tl = targets_of(texts, x.device)
        lo = loss(ws, x, L, tg, tl, rows, rounding)
        grads = torch.autograd.grad(lo, params)
        losses.append(float(lo.detach()))
        if k == 0:
            grad1 = leaves(_unflatten(ws, [g.detach() for g in grads]))
        if fault == "frozen":
            continue
        with torch.no_grad():
            for p, v, g in zip(params, vel, grads):
                v.mul_(momentum).add_(g)
                p.sub_(lr * v)
    p_end = leaves(ws)
    change = {n: (p_end[n].detach() - p0[n]) for n in p0}
    return {"losses": losses, "grad1": grad1, "change": change}


def _unflatten(ws: list, flat: list) -> list:
    out, at = [], 0
    for w in ws:
        d = {}
        for k in w:
            d[k] = flat[at]
            at += 1
        out.append(d)
    return out


def norms(tensors: dict) -> dict:
    """Each leaf's L2 norm, as a float64 number."""
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in
            tensors.items()}


def worst_leaf_gap(prog: dict, ref: dict, names) -> float:
    """max over ``names`` of |‖prog‖ - ‖ref‖| over the larger of the leaf's
    ‖ref‖ and the median leaf's ‖ref‖."""
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers that judge a program's first steps against the
    reference's on the same batches: ``prog`` and ``ref`` as ``steps``
    gives them, or with norms already taken ({"grad1_norms",
    "change_norms"}).
      loss_gap    max over the steps of |loss - ref| / |ref|
      grad_gap    the worst leaf's gap of the first gradient's norm
      change_gap  the worst leaf's gap of the norm of the parameters'
                  change over the steps, over the leaves the reference's
                  first gradient moves (not under STILL_LEAF of the
                  median leaf's)
    """
    def nrm(d, key):
        return d.get(key + "_norms") or norms(d[key])
    pg, rg = nrm(prog, "grad1"), nrm(ref, "grad1")
    pc, rc = nrm(prog, "change"), nrm(ref, "change")
    names = sorted(rg)
    med = statistics.median(rg[n] for n in names)
    moving = [n for n in names if rg[n] >= STILL_LEAF * med]
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": worst_leaf_gap(pg, rg, names),
        "change_gap": worst_leaf_gap(pc, rc, moving),
    }
