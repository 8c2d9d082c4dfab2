"""High-level task API: CLSTMOCR and CLSTMText (port of
clstm_tpu/models/hl.py).

Reference: clstmhl.h (≈L1-350, unverified). ``CLSTMOCR`` owns the line
normalizer and the image->sequence transpose; ``CLSTMText`` does
string->string transduction with a separate input codec and one-hot input
frames. Both share ``_TrainableBase``: ``train_batch`` / ``predict_batch``
(the batched entry points the reference's single-sample methods route
through), ``train_batch_refs`` / ``train_batch_block`` on batches gathered
from a device-resident corpus (data/device_cache.py), and ``save``/``load``
of the .clstm file with, beside it, the ``.state.npz`` TrainState sidecar
(io/checkpoint.py). ``CLSTMOCR.predict_batch_images`` runs the line
normalization on the device too (ops/preprocess.py).

``set_mesh`` makes the model data-parallel over torch.distributed ranks
(parallel/): every rank runs the same calls with the same arguments, the
training steps sum the gradients over the ranks, prediction splits the rows
over them, and rank 0 writes the files.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from clstm_tpu_torch.data.dataset import (
    S_BUCKETS, T_BUCKETS, TEXT_T_BUCKETS, bucket_for, encode_onehot,
    prepare_line)
from clstm_tpu_torch.io.checkpoint import load_state, save_state
from clstm_tpu_torch.io.normalize import make_normalizer
from clstm_tpu_torch.io.proto import load_net, save_net
from clstm_tpu_torch.models.codec import Codec
from clstm_tpu_torch.models.prefab import make_net_init
from clstm_tpu_torch.models.spec import (
    Layer, NetSpec, frame_stride, out_lengths)
from clstm_tpu_torch.ops.ctc import decode_frames, mktargets_ids
from clstm_tpu_torch.ops.preprocess import estimate_out_T, prepare_images
from clstm_tpu_torch.parallel.dp import (
    make_parallel_multi_train_step, make_parallel_train_step)
from clstm_tpu_torch.parallel.mesh import replicate
from clstm_tpu_torch.train import (
    TrainState, make_cached_train_step, make_multi_train_step,
    make_predict_step, make_train_step, unpack_report)
from clstm_tpu_torch.utils.config import torch_device
from clstm_tpu_torch.utils.profiling import span

_clamp_warned = False


def _warn_inference_clamp(T: int, tb: int) -> None:
    """One-time warning when an inference input exceeds the largest T bucket
    and gets clamped (silent truncation would quietly shorten
    transcriptions)."""
    global _clamp_warned
    if T > tb and not _clamp_warned:
        _clamp_warned = True
        warnings.warn(
            f"inference input of {T} frames exceeds the largest bucket "
            f"({tb}); output is truncated to the first {tb} frames",
            stacklevel=3)


def _canon_dewarp(kind: str) -> str:
    """CLI dewarp spellings -> ops/preprocess kind (mirrors make_normalizer)."""
    k = (kind or "center").lower()
    if k in ("center", "dewarp"):
        return "center"
    if k in ("mean",):
        return "mean"
    if k in ("none", "no"):
        return "none"
    raise ValueError(f"unknown normalizer: {kind!r}")


@dataclasses.dataclass
class CharPrediction:
    """Aligned per-character prediction (reference CharPrediction {i,x,c,p})."""

    i: int      # character index in the output string
    x: int      # x position (frame index mapped back to image columns)
    c: str      # predicted character
    p: float    # probability at the peak frame


class _TrainableBase:
    """Shared train/predict machinery over (spec, state, codecs). The net,
    its training state and every batch live on ``device``; asking for CUDA
    where there is none raises. ``mesh`` (set_mesh): the data-parallel
    group this model trains and predicts over, or None."""

    def __init__(self, *, device):
        self.device = torch_device(device)
        self.spec: Optional[NetSpec] = None
        self.state: Optional[TrainState] = None
        self.codec: Optional[Codec] = None
        self.icodec: Optional[Codec] = None
        self.lr = 1e-4
        self.momentum = 0.9
        self.normalization = "none"
        self.gradient_clip = 0.0   # >0 enables global-norm clipping
        self.augment = 0.0         # >0 enables on-device augmentation
        self._xz_bf16: Optional[bool] = None
        self.mesh = None
        self._reset_steps()

    @property
    def xz_bf16(self) -> Optional[bool]:
        """Precision of the bidi and affine layers (models/spec.py::
        ApplyCtx): None the card's default (models/spec.py::
        CARD_DEFAULT_BF16) and f32 on the CPU, True the bf16 mode, False
        strict f32. Setting it applies to prediction and training alike:
        the built steps are dropped and rebuilt in the new mode."""
        return self._xz_bf16

    @xz_bf16.setter
    def xz_bf16(self, value: Optional[bool]) -> None:
        self._xz_bf16 = value
        self._reset_steps()

    def _reset_steps(self) -> None:
        """Forget the built steps (a new net, or new step options). The
        gather steps are keyed by the group's one-hot width (0: the group
        holds frames), the K-step ones by (k, width): an image group and a
        text group each take their own. Under a mesh the state is made
        rank 0's again before the next step or prediction (_replicated)."""
        self._step = None
        self._predict = None
        self._cached_steps = {}
        self._multi_steps = {}
        self._replicated = False

    @property
    def net(self) -> Optional[Layer]:
        """The module tree (the parameters of ``state``)."""
        return None if self.state is None else self.state.net

    def out_lengths(self, lengths):
        """The net's output frames of lines of input ``lengths`` (an int,
        numpy or a tensor): what the alignment, the report and the decode
        run over. A net that keeps the frame count returns ``lengths``
        itself."""
        return out_lengths(self.spec, lengths)

    def _set_net(self, spec: NetSpec, net: Layer) -> None:
        self.spec = spec
        self.state = TrainState.create(net)
        self._reset_steps()

    # -- reference API --
    def setLearningRate(self, lr: float, momentum: float = 0.9) -> None:
        self.lr = float(lr)
        self.momentum = float(momentum)

    def set_mesh(self, mesh) -> None:
        """Train and predict data-parallel over ``mesh`` (parallel/mesh.py:
        this process's rank of a torch.distributed group, on this model's
        device): the training steps become the parallel steps (the
        gradients summed over the ranks: the single-rank update on the
        full batch), prediction splits the rows over the ranks, the state
        is made rank 0's (replicate) before the next step, and save writes
        on rank 0 only. Every rank must make the same calls; batch rows
        must divide by the mesh size (prediction pads them). None reverts
        to one rank."""
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"mesh on {mesh.device}, model on {self.device}")
        self.mesh = mesh
        self._reset_steps()

    def _sync(self) -> None:
        """Under a mesh, make the state rank 0's once after a new net, a
        load or set_mesh (a broadcast every rank joins)."""
        if self.mesh is not None and not self._replicated:
            replicate(self.state, self.mesh)
            self._replicated = True

    # -- checkpointing (reference save/load; .clstm proto format) --
    def save(self, fname: str, sidecar: bool = True) -> None:
        """Write the .clstm file (weights and codecs); with sidecar=True
        also ``fname + '.state.npz'``, the full TrainState (velocity and
        step), so a resumed run continues the same trajectory. Under a mesh
        rank 0 writes and every rank waits for it (a barrier), so a load on
        any rank reads the finished files."""
        if self.mesh is None or self.mesh.main:
            save_net(fname, self.net, codec=self.codec, icodec=self.icodec)
            if sidecar:
                save_state(fname + ".state.npz", self.state)
        if self.mesh is not None:
            self.mesh.barrier()

    def load(self, fname: str) -> None:
        """Load a .clstm file onto this model's device; if a matching
        ``.state.npz`` sidecar exists, also restore velocity and step."""
        spec, net, codec, icodec = load_net(fname, self.device)
        self._set_net(spec, net)
        sidecar = fname + ".state.npz"
        if os.path.exists(sidecar):
            try:
                self.state = load_state(sidecar, self.state)
            except (ValueError, KeyError) as e:
                warnings.warn(f"ignoring stale state sidecar {sidecar}: {e}")
        if codec is not None:
            self.codec = codec
        if icodec is not None:
            self.icodec = icodec

    # -- training --
    _BATCH_KEYS = ("x", "lengths", "targets", "target_lengths", "y")

    def _step_options(self) -> dict:
        return {"loss_kind": "ctc", "normalization": self.normalization,
                "gradient_clip": self.gradient_clip, "augment": self.augment,
                "xz_bf16": self.xz_bf16}

    def train_batch(self, batch: dict) -> dict:
        """One CTC training step on a prepared batch dict of numpy arrays
        (or tensors) {x, lengths, targets, target_lengths}. Returns metrics
        {loss, frame_ids, frame_vals, report_ids, report_vals, report}.
        Under a mesh every rank passes the same batch and trains on its
        rows (parallel/dp.py::make_parallel_train_step)."""
        self._sync()
        if self._step is None:
            self._step = (
                make_train_step(self.spec, self.lr, self.momentum,
                                **self._step_options())
                if self.mesh is None else
                make_parallel_train_step(self.spec, self.mesh, self.lr,
                                         self.momentum,
                                         **self._step_options()))
        tb = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()
              if k in self._BATCH_KEYS}
        self.state, metrics = self._step(self.state, tb, self.lr,
                                         self.momentum)
        return metrics

    def train_batch_refs(self, ref: dict) -> dict:
        """One training step on a DeviceDataset.epoch_refs batch: the rows
        are gathered from the resident corpus on the device (and expanded
        to one-hot frames for a text group). Metrics as train_batch; under
        a mesh the step runs as a block of one (train_batch_block), whose
        metrics are {loss, report, report_all}."""
        if self.mesh is not None:
            return self.train_batch_block(dict(ref, k=1))
        onehot = ref["group"].get("onehot", 0)
        step = self._cached_steps.get(onehot)
        if step is None:
            step = make_cached_train_step(
                self.spec, self.lr, self.momentum, input_onehot=onehot,
                **self._step_options())
            self._cached_steps[onehot] = step
        self.state, metrics, new_j = step(
            self.state, ref["group"], ref["idx_all"], ref["j"], self.lr,
            self.momentum)
        ref["set_j"](new_j)
        return metrics

    def train_batch_block(self, block: dict, k_max: int = 0,
                          nvalid: Optional[int] = None) -> dict:
        """The ``block['k']`` consecutive batches of a
        DeviceDataset.epoch_blocks block in one call
        (train.make_multi_train_step), reports returned together.

        ``k_max`` (the CLI's steps_per_dispatch) sizes the reports; shorter
        (remainder) blocks run as many steps as they hold. ``nvalid``
        (optional) runs only the first min(nvalid, k) batches — the CLI's
        ntrain budget clamp — and marks the block's plan exhausted, since
        its counter no longer matches the host's plan position.
        Under a mesh each rank gathers its own rows of every batch
        (parallel/dp.py::make_parallel_multi_train_step).
        Returns metrics {loss, report, report_all [max(k_max, k), 1+2T]}."""
        self._sync()
        k = max(k_max, block["k"])
        onehot = block["group"].get("onehot", 0)
        step = self._multi_steps.get((k, onehot))
        if step is None:
            step = (make_multi_train_step(self.spec, k, self.lr,
                                          self.momentum, input_onehot=onehot,
                                          **self._step_options())
                    if self.mesh is None else
                    make_parallel_multi_train_step(
                        self.spec, self.mesh, k, self.lr, self.momentum,
                        input_onehot=onehot, **self._step_options()))
            self._multi_steps[(k, onehot)] = step
        nv = block["k"] if nvalid is None else max(1, min(nvalid, block["k"]))
        with span("clstm.block"):
            self.state, metrics, new_j = step(
                self.state, block["group"], block["idx_all"], block["j"],
                nvalid=nv, lr_arg=self.lr, momentum_arg=self.momentum)
        block["set_j"](new_j)
        if nv < block["k"] and "exhaust" in block:
            block["exhaust"]()
        return metrics

    @staticmethod
    def _single_batch(x: np.ndarray, classes: Sequence[int],
                      t_buckets: Sequence[int]) -> dict:
        """One sample [T, D] and its classes -> a B=1 batch at its T bucket
        (over-bucket inputs clamp at the largest) and S bucket."""
        tb = bucket_for(x.shape[0], t_buckets)
        x = x[:tb]
        ids = mktargets_ids(classes)
        sb = bucket_for(len(ids), S_BUCKETS)
        xb = np.zeros((1, tb, x.shape[1]), np.float32)
        xb[0, : x.shape[0]] = x
        tg = np.zeros((1, sb), np.int32)
        tg[0, : len(ids)] = ids[:sb]
        return {"x": xb,
                "lengths": np.array([x.shape[0]], np.int32),
                "targets": tg,
                "target_lengths": np.array([min(len(ids), sb)], np.int32)}

    # -- inference --
    def _predict_rows(self, x: torch.Tensor, lengths: torch.Tensor):
        """(ids, vals) tensors of a batch on the device
        (train.make_predict_step). Under a mesh the rows are padded with
        zero-length rows (masked everywhere) to a multiple of the mesh
        size, split over the ranks and put back together on every rank,
        and the padding is cut off."""
        self._sync()
        if self._predict is None:
            self._predict = make_predict_step(self.spec, mesh=self.mesh,
                                              xz_bf16=self.xz_bf16)
        B = x.shape[0]
        pad = 0 if self.mesh is None else (-B) % self.mesh.size
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
            lengths = torch.cat([lengths, lengths.new_zeros(pad)])
        ids, vals = self._predict(self.net, x, lengths)
        return ids[:B], vals[:B]

    def predict_batch(self, x, lengths):
        """Right-padded [B, T, D] inputs and their lengths (numpy, or
        tensors on the model's device) -> per-frame (ids [B, T], vals
        [B, T]) numpy arrays: the no-grad forward on the model's device,
        then the per-frame argmax (under a mesh, every rank passes the same
        batch and gets all of it back)."""
        xt = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        lt = torch.as_tensor(lengths, dtype=torch.int32).to(self.device)
        ids, vals = self._predict_rows(xt.contiguous(), lt)
        return ids.cpu().numpy(), vals.cpu().numpy()

    def _predict_one(self, x: np.ndarray, t_buckets: Sequence[int]):
        """One sample [T, D] -> its frames' (ids, vals), run as a B=1 batch
        at its T bucket (over-bucket inputs clamp, with a warning)."""
        tb = bucket_for(x.shape[0], t_buckets)
        _warn_inference_clamp(x.shape[0], tb)
        x = x[:tb]
        xb = np.zeros((1, tb, x.shape[1]), np.float32)
        xb[0, : x.shape[0]] = x
        ids, vals = self.predict_batch(xb, np.array([x.shape[0]], np.int32))
        L = self.out_lengths(x.shape[0])
        return ids[0][:L], vals[0][:L]


class CLSTMOCR(_TrainableBase):
    """Line-image OCR (reference CLSTMOCR, clstmhl.h ≈L60-250).

    Inputs are float [h, w] grayscale images in [0, 1] (ink black on white);
    the time axis is the image width.
    """

    def __init__(self, target_height: int = 48, dewarp: str = "center",
                 pad: int = 16, *, device):
        super().__init__(device=device)
        self.target_height = target_height
        self.dewarp = dewarp
        self.pad = pad
        self._scale = 1.0

    def createBidi(self, codec: Codec, nhidden: int, kind: str = "bidi",
                   seed: int = 0, **extra) -> None:
        """Build the standard bidi LSTM net: ninput=target_height,
        noutput=codec.size() (reference createBidi -> make_net("bidi")),
        weights drawn from a torch.Generator seeded with ``seed``."""
        self.codec = codec
        args = {"ninput": self.target_height, "nhidden": nhidden,
                "noutput": codec.size(), **extra}
        self._set_net(*make_net_init(
            kind, args, torch.Generator().manual_seed(seed), self.device))

    def train_utf8(self, image: np.ndarray, gt: str) -> str:
        """Train on one line; returns the (pre-update) prediction string."""
        x = self.prepare(image)
        batch = self._single_batch(x, self.codec.encode(gt), T_BUCKETS)
        metrics = self.train_batch(batch)
        _, ids, vals = unpack_report(metrics["report"],
                                     self.out_lengths(x.shape[0]))
        return self.codec.decode(decode_frames(ids, vals))

    # -- preprocessing --
    def prepare(self, image: np.ndarray) -> np.ndarray:
        norm = make_normalizer(self.dewarp, self.target_height)
        x = prepare_line(image, norm, self.pad)
        # Width scale of the last prepared line (normalized cols per source
        # col), for mapping frame positions back to image x coordinates.
        self._scale = float(getattr(norm, "scale", 1.0)) or 1.0
        return x

    # -- inference --
    def predict_batch_images(self, images: Sequence[np.ndarray],
                             sync: bool = True):
        """Batched inference from RAW line images with the normalization and
        transposition on the device (ops/preprocess.py prepare_images): the
        raw lines are packed (uint8 where they are 8-bit), uploaded and
        prepared in chunks of at most PREPARE_CHUNK lines, which bounds the
        prepare's memory, and predicted on the device as one batch.

        -> (ids [B, T], vals [B, T], lengths [B]) numpy arrays, T and
        lengths the net's output frames (``out_lengths``: the prepared
        lines' own for a net that keeps the frame count); with
        ``sync=False``, tensors on the device, returned without waiting for
        it: the upload goes through pinned memory and nothing here reads a
        result back, so a caller can enqueue several batches before it
        reads any (clstmocr.predict_pages).
        """
        est_T = estimate_out_T(images, self.target_height, self.pad)
        tb = bucket_for(est_T, T_BUCKETS)
        _warn_inference_clamp(est_T, tb)
        x, lengths = prepare_images(
            list(images), self.device, kind=_canon_dewarp(self.dewarp),
            target_height=self.target_height, out_T=tb, pad=self.pad)
        ids, vals = self._predict_rows(x, lengths)
        lengths = self.out_lengths(lengths)
        if not sync:
            return ids, vals, lengths
        return ids.cpu().numpy(), vals.cpu().numpy(), lengths.cpu().numpy()

    def predict_utf8(self, image: np.ndarray) -> str:
        x = self.prepare(image)
        ids, vals = self._predict_one(x, T_BUCKETS)
        return self.codec.decode(decode_frames(ids, vals))

    def predict(self, image: np.ndarray) -> List[CharPrediction]:
        """Aligned per-character predictions (reference aligned/charseg).

        ``x`` is reported in ORIGINAL image columns: the peak frame index
        (in input frames: times the net's ``frame_stride``) is un-padded,
        then divided by the normalizer's width scale."""
        x = self.prepare(image)
        w = image.shape[1]
        ids, vals = self._predict_one(x, T_BUCKETS)
        cls, pos = decode_frames(ids, vals, return_positions=True)
        stride = frame_stride(self.spec)
        out = []
        for i, (c, t) in enumerate(zip(cls, pos)):
            col = (int(t) * stride - self.pad) / self._scale
            out.append(CharPrediction(
                i=i, x=int(np.clip(round(col), 0, max(w - 1, 0))),
                c=chr(self.codec.codec[c]), p=float(vals[t])))
        return out


# Single text samples (CLSTMText.train / predict): TEXT_T_BUCKETS up to its
# 512 frames, then T_BUCKETS, whose last bucket (4,096) clamps as the JAX
# package's does. A 10-character input runs 16 frames, not 128 (padded
# frames are masked, so the outputs are the same).
TEXT_ONE_BUCKETS = TEXT_T_BUCKETS + tuple(
    t for t in T_BUCKETS if t > TEXT_T_BUCKETS[-1])


class CLSTMText(_TrainableBase):
    """String->string transduction (reference CLSTMText, clstmhl.h ≈L250).

    Input strings are one-hot encoded with a separate input codec
    (``icodec``); outputs decode through ``codec``.

    ``input_repeat`` repeats each input frame k times (1, the default, is
    the reference's behaviour). Where outputs are nearly as long as the
    inputs (grapheme->phoneme), CTC has no alignment slack at k=1 and
    training stalls; k>=2 gives it slack. It is kept in the net's attrs,
    so a .clstm file restores it.
    """

    def __init__(self, input_repeat: int = 1, *, device):
        super().__init__(device=device)
        self.input_repeat = max(1, int(input_repeat))

    def createBidi(self, icodec: Codec, codec: Codec, nhidden: int,
                   kind: str = "bidi", seed: int = 0, **extra) -> None:
        """The prefab net ``kind`` with ninput=icodec.size() and
        noutput=codec.size(), weights drawn from a torch.Generator seeded
        with ``seed``."""
        self.icodec = icodec
        self.codec = codec
        args = {"ninput": icodec.size(), "nhidden": nhidden,
                "noutput": codec.size(), **extra}
        spec, net = make_net_init(kind, args,
                                  torch.Generator().manual_seed(seed),
                                  self.device)
        if self.input_repeat != 1:
            # In the root's attrs, so the .clstm file restores the input
            # encoding (a k=3 model decodes garbage at k=1).
            spec = net.spec = spec.with_attr(input_repeat=self.input_repeat)
        self._set_net(spec, net)

    def load(self, fname: str) -> None:
        super().load(fname)
        self.input_repeat = int(self.spec.get("input_repeat", "1"))

    def encode_input(self, s: str) -> np.ndarray:
        """One-hot [T, icodec.size()] frames of the input string, each
        character repeated ``input_repeat`` times."""
        return encode_onehot(self.icodec.encode(s), self.icodec.size(),
                             self.input_repeat)

    def _one_batch(self, x: np.ndarray, classes: Sequence[int]) -> dict:
        return self._single_batch(x, classes, TEXT_ONE_BUCKETS)

    def train(self, inp: str, out: str) -> str:
        """Train on one pair; returns the (pre-update) prediction."""
        x = self.encode_input(inp)
        metrics = self.train_batch(self._one_batch(x, self.codec.encode(out)))
        _, ids, vals = unpack_report(metrics["report"],
                                     self.out_lengths(x.shape[0]))
        return self.codec.decode(decode_frames(ids, vals))

    def predict(self, inp: str) -> str:
        ids, vals = self._predict_one(self.encode_input(inp),
                                      TEXT_ONE_BUCKETS)
        return self.codec.decode(decode_frames(ids, vals))
