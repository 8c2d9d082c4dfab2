"""Data-parallel training steps over torch.distributed (port of
clstm_tpu/parallel/dp.py).

Each rank computes the CTC-alignment loss and its gradients on its own rows
of the global batch; the loss and every gradient are SUMMED over the ranks
(the JAX package's psum, not DDP's or pmean's average) in one all_reduce of
one flat buffer; the clip comes after the sum; and every rank applies the
same SGD update, so the state stays replicated. Per-line contributions are
summed in both cases, so the update is the single-rank update on the
concatenated batch, up to the order of the f32 sums.

The report is global row 0, which lives on rank 0 (its local row 0): it
rides the same all_reduce, rank 0 writing its row and the others zeros (the
JAX package's masked psum), so a step makes one collective.

Every rank calls a step with the same arguments (the global batch, or the
same epoch plan): callers such as models/hl.py and the CLIs run the same
code on every rank, as the JAX package's single controller runs it once.
"""

from __future__ import annotations

from typing import Optional

import torch

from clstm_tpu_torch.models.spec import ApplyCtx, NetSpec, out_lengths
from clstm_tpu_torch.ops.ctc import greedy_frames
from clstm_tpu_torch.parallel.mesh import Mesh, pack, shard_rows, unpack
from clstm_tpu_torch.train import (
    _LOSSES, TrainState, apply_update, augmented, check_spec, gather_batch,
    loss_and_grads)
from clstm_tpu_torch.utils.config import to_device


def psum_tree(tree: dict, mesh: Mesh) -> dict:
    """Every tensor of ``tree`` summed over the ranks (one all_reduce of one
    flat buffer)."""
    flat = pack(tree.values())
    mesh.all_reduce(flat)
    return dict(zip(tree, unpack(flat, tree.values())))


def pmean_tree(tree: dict, mesh: Mesh) -> dict:
    """Every tensor of ``tree`` averaged over the ranks."""
    return {k: v / mesh.size for k, v in psum_tree(tree, mesh).items()}


def _make_device_step_fn(spec: NetSpec, mesh: Mesh, loss_kind: str,
                         normalization: str, compute_dtype,
                         gradient_clip: float, augment: float,
                         augment_seed: int, xz_bf16: Optional[bool],
                         frames: bool):
    """The per-rank step body shared by make_parallel_train_step and
    make_parallel_multi_train_step: loss and gradients on this rank's rows
    (on mesh.device), one all_reduce(SUM) of the loss, every gradient and
    the report, then the clip, the SGD update and the report.

    ``frames``: the buffer also carries the per-frame (ids, vals) of every
    row ([B, T] each, zero but for this rank's rows), so the metrics cover
    the global batch; else only global row 0's, the report.
    ``compute_dtype``: the scan recipe (train.make_train_step); each rank
    takes its own gradients in it, summed in f32 over the ranks."""
    ApplyCtx(xz_bf16=xz_bf16, compute_dtype=compute_dtype)   # modes checked
    loss_fn = _LOSSES[loss_kind]

    def device_step(state: TrainState, batch: dict, lr_t, momentum_t):
        check_spec(state, spec)
        # Each rank draws its own augmentation stream: the key folds in
        # the step and the rank, so DP matches one rank only at augment=0.
        batch = augmented(batch, augment, augment_seed, state.step,
                          mesh.rank)
        loss, grads, probs = loss_and_grads(state.net, batch, loss_fn,
                                            normalization, xz_bf16,
                                            compute_dtype)
        ids, vals = greedy_frames(probs)
        b, T = ids.shape
        if frames:
            rep = ids.new_zeros((2, b * mesh.size, T), dtype=torch.float32)
            rep[0, mesh.rows(b * mesh.size)] = ids.float()
            rep[1, mesh.rows(b * mesh.size)] = vals.float()
        else:
            rep = ids.new_zeros((2, T), dtype=torch.float32)
            if mesh.main:
                rep[0] = ids[0].float()
                rep[1] = vals[0].float()
        like = [loss, *grads.values(), rep]
        flat = pack(like)
        mesh.all_reduce(flat)
        loss, *summed, rep = unpack(flat, like)
        apply_update(state, dict(zip(grads, summed)), gradient_clip, lr_t,
                     momentum_t)
        row0 = rep[:, 0] if frames else rep
        packed = torch.cat([loss.reshape(1), row0[0], row0[1]])
        metrics = {"loss": loss, "report_ids": row0[0].to(ids.dtype),
                   "report_vals": row0[1], "report": packed}
        if frames:
            metrics["frame_ids"] = rep[0].to(ids.dtype)
            metrics["frame_vals"] = rep[1]
        return state, metrics

    return device_step


def make_parallel_train_step(spec: NetSpec, mesh: Mesh, lr: float = 1e-4,
                             momentum: float = 0.9, *,
                             loss_kind: str = "ctc",
                             normalization: str = "none",
                             compute_dtype=None, gradient_clip: float = 0.0,
                             augment: float = 0.0, augment_seed: int = 0,
                             xz_bf16: Optional[bool] = None):
    """The data-parallel training step.

    step(state, batch, lr_arg=None, momentum_arg=None) -> (state, metrics),
    called on every rank with the same GLOBAL batch (numpy arrays or
    tensors): each rank takes its rows (shard_rows), on mesh.device.
    Gradients and the loss are summed over the ranks, so the update equals
    the single-rank update on the full batch (summed per-line
    contributions). metrics as train.make_train_step's: the loss, the
    per-frame ids/vals of the full batch [B, T] (they ride the step's one
    all_reduce: 2·B·T floats beside the gradients), row 0's and the packed
    report. With augment > 0 each rank draws its own stream (the step and
    the rank folded into the seed), so the trajectory matches one rank only
    at augment=0."""
    device_step = _make_device_step_fn(
        spec, mesh, loss_kind, normalization, compute_dtype, gradient_clip,
        augment, augment_seed, xz_bf16, frames=True)

    def step(state: TrainState, batch: dict, lr_arg=None, momentum_arg=None):
        local = {k: (v.to(mesh.device) if torch.is_tensor(v)
                     else to_device(v, mesh.device))
                 for k, v in shard_rows(batch, mesh).items()}
        return device_step(state, local, lr if lr_arg is None else lr_arg,
                           momentum if momentum_arg is None
                           else momentum_arg)

    return step


def make_parallel_multi_train_step(spec: NetSpec, mesh: Mesh, k: int,
                                   lr: float = 1e-4, momentum: float = 0.9,
                                   *, loss_kind: str = "ctc",
                                   normalization: str = "none",
                                   compute_dtype=None,
                                   gradient_clip: float = 0.0,
                                   augment: float = 0.0,
                                   augment_seed: int = 0,
                                   input_onehot: int = 0,
                                   xz_bf16: Optional[bool] = None):
    """K gather+train steps per call over consecutive batches of a
    device-resident epoch plan, data-parallel over ``mesh``: the
    counterpart of train.make_multi_train_step, with its calling
    convention and metrics.

    step(state, group, idx_all, j, nvalid=None, lr_arg=None,
    momentum_arg=None) -> (state, metrics, j + nvalid). Every rank holds the
    whole corpus (data/device_cache.py with ``mesh``) and the same [nb, B]
    plan; at each step it gathers only its own rows of the plan row,
    idx_all[j+s][rank*B/n:(rank+1)*B/n], and sums loss, gradients and
    report with the other ranks. Only the first min(nvalid, k) batches run
    (nvalid defaults to k). metrics = {"loss", "report", "report_all"
    [k, 1+2T], zero rows from nvalid on}; the report is global row 0's.
    ``input_onehot`` > 0: the group holds int input ids, expanded to one-hot
    frames of that width after the gather."""
    device_step = _make_device_step_fn(
        spec, mesh, loss_kind, normalization, compute_dtype, gradient_clip,
        augment, augment_seed, xz_bf16, frames=False)

    def wrapped(state: TrainState, group: dict, idx_all: torch.Tensor,
                j: int, nvalid=None, lr_arg=None, momentum_arg=None):
        n = k if nvalid is None else max(1, min(int(nvalid), k))
        rows = mesh.rows(idx_all.shape[1])
        lr_t = lr if lr_arg is None else lr_arg
        mom_t = momentum if momentum_arg is None else momentum_arg
        x = group["x"]    # frames, or int ids of a text group
        reports = torch.zeros((k, 1 + 2 * out_lengths(spec, x.shape[1])),
                              device=x.device)
        for s in range(n):
            state, metrics = device_step(
                state, gather_batch(group, idx_all[j + s][rows],
                                    input_onehot), lr_t, mom_t)
            reports[s] = metrics["report"]
        last = reports[n - 1]
        return state, {"loss": last[0], "report": last,
                       "report_all": reports}, j + n

    return wrapped
