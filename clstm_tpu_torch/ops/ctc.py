"""Greedy CTC decoding (port of the decode half of clstm_tpu/ops/ctc.py).

Reference ``trivial_decode`` (clstm.cc ≈L1250, unverified): the device
computes per-frame argmax ids and their probabilities; the host runs the
stateful run-collapse. The alignment DP (training) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


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
