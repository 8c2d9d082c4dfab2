"""Training: the CTC-alignment loss and the reference's SGD semantics (port
of clstm_tpu/train.py).

Reference training step (clstmocrtrain.cc ≈L100 / clstmhl.h train_utf8,
all ≈L unverified):
  forward -> ctc_align_targets -> inject ``outputs.d = aligned - outputs.v``
  -> backward -> sgd_update.

Two semantics are replicated exactly, as in the JAX package:

1. **Delta convention.** The reference injects the delta at the post-
   softmax outputs, but backward_softmax applies it as the pre-activation
   (logit) delta. The equivalent here is the cross-entropy surrogate
   ``loss = -sum(aligned.detach() * log_softmax(logits))`` whose logit
   gradient is ``probs - aligned``.
2. **Momentum.** Heavy ball: velocity_k = grad_k + mu*velocity_{k-1},
   params -= lr * velocity_k.

Learning-rate normalization modes {none, len, batch} scale each line's
contribution.

Unlike the JAX package, nothing is jitted and nothing is donated: a step
runs eagerly and updates the module's parameters and the velocity IN PLACE
(the returned state is the state passed in, its step counter advanced).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from clstm_tpu_torch.models.spec import ApplyCtx, Layer, NetSpec, apply_net
from clstm_tpu_torch.ops.ctc import ctc_align_targets_batched, greedy_frames
from clstm_tpu_torch.ops.preprocess import augment_generator, augment_lines
from clstm_tpu_torch.ops.seq import length_mask


@dataclasses.dataclass
class TrainState:
    """The module tree (the parameters), one velocity tensor per parameter
    (keyed by its name in ``net.named_parameters()``) and the step count."""

    net: Layer
    velocity: dict
    step: int = 0

    @classmethod
    def create(cls, net: Layer) -> "TrainState":
        return cls(net=net,
                   velocity={n: torch.zeros_like(p)
                             for n, p in net.named_parameters()},
                   step=0)


@torch.no_grad()
def sgd_update(net: Layer, velocity: dict, grads: dict, lr: float,
               momentum: float) -> None:
    """One reference-semantics SGD step, in place:
    velocity_k = grad_k + momentum * velocity_{k-1};  p -= lr * velocity_k.
    """
    for name, p in net.named_parameters():
        v = velocity[name]
        v.copy_(grads[name] + momentum * v)
        p.sub_(lr * v)


def _reduce_lines(per_line: torch.Tensor, lengths: torch.Tensor, B: int,
                  normalization: str) -> torch.Tensor:
    if normalization == "len":
        return torch.sum(per_line / torch.clamp(lengths.float(), min=1.0))
    if normalization == "batch":
        return torch.sum(per_line) / B
    if normalization == "none":
        return torch.sum(per_line)
    raise ValueError(f"unknown normalization: {normalization!r}")


def ctc_alignment_loss(net: Layer, batch: dict, *, normalization: str = "none",
                       compute_dtype=None, xz_bf16: Optional[bool] = None):
    """The reference training objective as a scalar surrogate loss.

    batch: {"x": [B,T,D], "lengths": [B] int32, "targets": [B,S]
    blank-interleaved class ids, "target_lengths": [B] int32}, tensors on
    the net's device. Returns (loss, (probs, aligned)). ``xz_bf16``: the
    forward's precision (models/spec.py::ApplyCtx; None: the card's
    default, CARD_DEFAULT_BF16, and f32 on the CPU); ``compute_dtype``
    (e.g. torch.bfloat16): the JAX package's scan recipe in its place, no
    LSTM kernel. The logits and the alignment are f32 either way: as in
    the JAX package, compute_dtype reaches only the net, and the alignment
    stays exact f32 (ROADMAP.md Queue 3, "CTC matmul precision").
    """
    x, lengths = batch["x"], batch["lengths"]
    logits = apply_net(net, x, lengths, logits=True, xz_bf16=xz_bf16,
                       compute_dtype=compute_dtype).float()
    probs = torch.softmax(logits, dim=-1)
    with torch.no_grad():
        aligned = ctc_align_targets_batched(
            probs.detach(), batch["targets"], lengths=lengths,
            target_lengths=batch["target_lengths"])
    mask = length_mask(lengths, x.shape[1])
    ll = F.log_softmax(logits, dim=-1)
    per_line = torch.sum(-torch.sum(aligned * ll, dim=-1) * mask, dim=-1)
    loss = _reduce_lines(per_line, lengths, x.shape[0], normalization)
    return loss, (probs.detach(), aligned)


def frame_target_loss(net: Layer, batch: dict, *, normalization: str = "none",
                      compute_dtype=None, xz_bf16: Optional[bool] = None):
    """Direct per-frame supervision (the reference test-lstm.cc setup).

    batch: {"x": [B,T,D], "lengths": [B], "y": [B,T,C] one-hot frame
    targets}. ``compute_dtype`` and ``xz_bf16`` as in ctc_alignment_loss.
    """
    x, lengths = batch["x"], batch["lengths"]
    logits = apply_net(net, x, lengths, logits=True, xz_bf16=xz_bf16,
                       compute_dtype=compute_dtype).float()
    probs = torch.softmax(logits, dim=-1)
    mask = length_mask(lengths, x.shape[1])
    ll = F.log_softmax(logits, dim=-1)
    per_line = torch.sum(-torch.sum(batch["y"] * ll, dim=-1) * mask, dim=-1)
    loss = _reduce_lines(per_line, lengths, x.shape[0], normalization)
    return loss, (probs.detach(), batch["y"])


_LOSSES = {"ctc": ctc_alignment_loss, "frames": frame_target_loss}


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """Scale the gradients so their global L2 norm is <= max_norm (an
    opt-in stability addition; the reference has no clipping)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def unpack_report(report, L: Optional[int] = None):
    """Unpack a step's packed ``report`` = [loss, ids[0][:T], vals[0][:T]]
    (f32) -> (loss, ids[:L] int64, vals[:L]) with one device-to-host copy."""
    rep = (report.detach().cpu().numpy() if torch.is_tensor(report)
           else np.asarray(report))
    T = (rep.shape[0] - 1) // 2
    ids = rep[1:1 + T].astype(np.int64)
    vals = rep[1 + T:]
    if L is not None:
        ids, vals = ids[:L], vals[:L]
    return float(rep[0]), ids, vals


def make_train_step(spec: NetSpec, lr: float = 1e-4, momentum: float = 0.9, *,
                    loss_kind: str = "ctc", normalization: str = "none",
                    compute_dtype=None, gradient_clip: float = 0.0,
                    augment: float = 0.0, augment_seed: int = 0,
                    xz_bf16: Optional[bool] = None):
    """Build the training step.

    Returns step(state, batch, lr_arg=None, momentum_arg=None) ->
    (state, metrics): lr and momentum are read at each call (reference
    setLearningRate). metrics carries the scalar loss, the per-frame argmax
    ids/probs [B, T], row 0's ids/probs, and ``report``, those three packed
    into one f32 vector. gradient_clip > 0 enables global-norm clipping;
    augment > 0 distorts each batch on the device first (augment_lines).
    ``spec`` names the topology the step is built for; the state's net must
    have it. ``xz_bf16`` is the precision of the bidi and affine layers
    (models/spec.py::ApplyCtx; None: the card's default, f32 on the CPU);
    ``compute_dtype`` (e.g. torch.bfloat16) the JAX package's scan recipe
    in its place, which runs no LSTM kernel (the CTC kernels run as ever);
    parameters, velocity and update stay f32. The step is also the body of
    make_cached_train_step and make_multi_train_step.
    """
    ApplyCtx(xz_bf16=xz_bf16, compute_dtype=compute_dtype)   # modes checked
    loss_fn = _LOSSES[loss_kind]

    def step(state: TrainState, batch: dict, lr_arg=None, momentum_arg=None):
        check_spec(state, spec)
        batch = augmented(batch, augment, augment_seed, state.step)
        loss, grads, probs = loss_and_grads(state.net, batch, loss_fn,
                                            normalization, xz_bf16,
                                            compute_dtype)
        apply_update(state, grads, gradient_clip,
                     lr if lr_arg is None else lr_arg,
                     momentum if momentum_arg is None else momentum_arg)
        ids, vals = greedy_frames(probs)
        packed = torch.cat([loss.reshape(1), ids[0].float(), vals[0].float()])
        metrics = {"loss": loss, "frame_ids": ids, "frame_vals": vals,
                   "report_ids": ids[0], "report_vals": vals[0],
                   "report": packed}
        return state, metrics

    return step


def check_spec(state: TrainState, spec: NetSpec) -> None:
    if state.net.spec != spec:
        raise ValueError("the state's net was not built from this spec")


def augmented(batch: dict, augment: float, augment_seed: int, step: int,
              *fold: int) -> dict:
    """The batch with x distorted on the device (augment_lines) when
    augment > 0, drawn from a generator seeded by (augment_seed, step,
    *fold); augment=0 (the default) is exact reference semantics."""
    if augment <= 0:
        return batch
    gen = augment_generator(augment_seed, step, batch["x"].device, *fold)
    return dict(batch, x=augment_lines(gen, batch["x"], batch["lengths"],
                                       augment))


def loss_and_grads(net: Layer, batch: dict, loss_fn, normalization: str,
                   xz_bf16: Optional[bool], compute_dtype=None):
    """The loss on ``batch`` and its gradient, one tensor per parameter
    (zeros for a parameter the loss does not reach). -> (loss detached,
    grads by parameter name, probs)."""
    net.zero_grad(set_to_none=True)
    loss, (probs, _) = loss_fn(net, batch, normalization=normalization,
                               xz_bf16=xz_bf16, compute_dtype=compute_dtype)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in net.named_parameters()}
    net.zero_grad(set_to_none=True)
    return loss.detach(), grads, probs


def apply_update(state: TrainState, grads: dict, gradient_clip: float,
                 lr, momentum) -> None:
    """Clip (gradient_clip > 0), the SGD update in place, step + 1."""
    if gradient_clip > 0:
        grads = clip_by_global_norm(grads, gradient_clip)
    sgd_update(state.net, state.velocity, grads, float(lr), float(momentum))
    state.step += 1


def onehot_frames(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Int ids [...] -> f32 one-hot [..., n], by comparison with arange(n)
    on the ids' device: an id outside [0, n) (the -1 of a padded frame or
    the sentinel row) gives an all-zero frame, as jax.nn.one_hot does
    (torch.nn.functional.one_hot raises on it)."""
    return (ids.unsqueeze(-1) == torch.arange(
        n, device=ids.device, dtype=ids.dtype)).float()


def gather_batch(group: dict, idx: torch.Tensor,
                 input_onehot: int = 0) -> dict:
    """Batch rows ``idx`` of a DeviceDataset group, gathered on its device.
    ``input_onehot`` > 0: the group holds int input ids (TextDeviceDataset)
    and the gathered rows are expanded to one-hot frames of that width."""
    x = group["x"].index_select(0, idx)
    if input_onehot:
        x = onehot_frames(x, input_onehot)
    return {"x": x,
            "lengths": group["lengths"].index_select(0, idx),
            "targets": group["targets"].index_select(0, idx),
            "target_lengths": group["tlens"].index_select(0, idx)}


def make_cached_train_step(spec: NetSpec, lr: float = 1e-4,
                           momentum: float = 0.9, *, loss_kind: str = "ctc",
                           normalization: str = "none", compute_dtype=None,
                           gradient_clip: float = 0.0, augment: float = 0.0,
                           augment_seed: int = 0, input_onehot: int = 0,
                           xz_bf16: Optional[bool] = None):
    """Gather+train step over a device-resident cache group.

    step(state, group, idx_all, j, lr_arg=None, momentum_arg=None) ->
    (state, metrics, j + 1): ``group`` is a DeviceDataset group dict (the
    resident x/targets/lengths/tlens tensors, sentinel row included),
    ``idx_all`` the epoch's [nb, B] index plan on the same device and ``j``
    the batch to take from it. The batch is gathered on the device, so a
    batch costs no host-to-device copy. ``input_onehot`` > 0: the group
    holds int input ids (data/device_cache.py TextDeviceDataset), expanded
    after the gather to one-hot frames of that width (gather_batch)."""
    step = make_train_step(spec, lr, momentum, loss_kind=loss_kind,
                           normalization=normalization,
                           compute_dtype=compute_dtype,
                           gradient_clip=gradient_clip, augment=augment,
                           augment_seed=augment_seed, xz_bf16=xz_bf16)

    def wrapped(state: TrainState, group: dict, idx_all: torch.Tensor,
                j: int, lr_arg=None, momentum_arg=None):
        state, metrics = step(
            state, gather_batch(group, idx_all[j], input_onehot), lr_arg,
            momentum_arg)
        return state, metrics, j + 1

    return wrapped


def make_multi_train_step(spec: NetSpec, k: int, lr: float = 1e-4,
                          momentum: float = 0.9, *, loss_kind: str = "ctc",
                          normalization: str = "none", compute_dtype=None,
                          gradient_clip: float = 0.0, augment: float = 0.0,
                          augment_seed: int = 0, input_onehot: int = 0,
                          xz_bf16: Optional[bool] = None):
    """K gather+train steps per call, over consecutive batches of a
    device-resident epoch plan: a plain loop of the make_cached_train_step
    body (the JAX package scans it inside one dispatch; a CUDA graph would
    be the counterpart, taken only once a measurement shows the loop bound
    by launches).

    step(state, group, idx_all, j, nvalid=None, lr_arg=None,
    momentum_arg=None) -> (state, metrics, j + nvalid). Only the first
    min(nvalid, k) batches run (nvalid defaults to k); the rest leave state
    and counter untouched. metrics = {"loss": the last valid step's loss,
    "report": its packed report, "report_all": [k, 1+2T], every step's
    packed (loss, row-0 ids, row-0 vals), zero rows from nvalid on}, so a
    caller reads a block's reports in one copy. ``input_onehot`` as in
    make_cached_train_step."""
    step = make_train_step(spec, lr, momentum, loss_kind=loss_kind,
                           normalization=normalization,
                           compute_dtype=compute_dtype,
                           gradient_clip=gradient_clip, augment=augment,
                           augment_seed=augment_seed, xz_bf16=xz_bf16)

    def wrapped(state: TrainState, group: dict, idx_all: torch.Tensor,
                j: int, nvalid=None, lr_arg=None, momentum_arg=None):
        n = k if nvalid is None else max(1, min(int(nvalid), k))
        x = group["x"]    # frames, or int ids of a text group
        reports = torch.zeros((k, 1 + 2 * x.shape[1]), device=x.device)
        for s in range(n):
            state, metrics = step(
                state, gather_batch(group, idx_all[j + s], input_onehot),
                lr_arg, momentum_arg)
            reports[s] = metrics["report"]
        last = reports[n - 1]
        return state, {"loss": last[0], "report": last,
                       "report_all": reports}, j + n

    return wrapped


def make_predict_step(spec: NetSpec, *, compute_dtype=None, mesh=None,
                      xz_bf16: Optional[bool] = None):
    """Inference: predict(net, x, lengths) -> per-frame (ids, vals), the
    no-grad forward then the per-frame argmax, at the precision ``xz_bf16``
    (None: the card's default, f32 on the CPU) or ``compute_dtype`` (the
    scan recipe, no LSTM kernel).

    With ``mesh`` (parallel/mesh.py), every rank passes the same global
    batch, runs the forward on its own rows and gets the full [B, T] ids and
    values back (gather_rows: one all_reduce of zero-filled buffers, each
    rank writing its rows). Batch rows must divide by the mesh size."""
    ApplyCtx(xz_bf16=xz_bf16, compute_dtype=compute_dtype)   # modes checked
    # parallel/ imports this module: import its helper here.
    from clstm_tpu_torch.parallel.mesh import gather_rows

    def predict(net: Layer, x: torch.Tensor, lengths: Optional[torch.Tensor]):
        rows = slice(None) if mesh is None else mesh.rows(x.shape[0])
        probs = apply_net(net, x[rows].contiguous(),
                          None if lengths is None else lengths[rows],
                          inference=True, xz_bf16=xz_bf16,
                          compute_dtype=compute_dtype)
        frames = greedy_frames(probs.float())
        if mesh is None:
            return frames
        return tuple(gather_rows(frames, mesh, x.shape[0]))

    return predict


def make_forward(spec: NetSpec, *, compute_dtype=None,
                 xz_bf16: Optional[bool] = None):
    """Plain forward (posteriors), for tests and external use, at the
    precision ``xz_bf16`` (None: the card's default, f32 on the CPU) or
    ``compute_dtype`` (the scan recipe, no LSTM kernel)."""
    ApplyCtx(xz_bf16=xz_bf16, compute_dtype=compute_dtype)   # modes checked

    def forward(net: Layer, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None):
        return apply_net(net, x, lengths, xz_bf16=xz_bf16,
                         compute_dtype=compute_dtype)

    return forward
