"""NetSpec: static network topology, the layer registry, and one
``nn.Module`` per layer kind (port of clstm_tpu/models/spec.py).

Reference mapping (≈L unverified, SURVEY.md §0): ``INetwork`` {kind, attr
Assoc, sub networks} -> frozen ``NetSpec`` tree plus the module tree built
from it; the global layer registry + ``make_layer(kind)`` -> ``REGISTRY`` /
``make_layer`` keyed by the same kind strings, so .clstm files reconstruct.

``LayerDef`` has no counterpart: the JAX package's registry entry holds a
kind's init, apply and noutput functions because its weights are a pytree
apart from the code; here a kind is an ``nn.Module`` class holding its own
weights, with ``reset_parameters`` for the init, ``forward`` for the apply
and ``noutput`` for the output dim (``noutput_of``), so ``REGISTRY`` maps
each kind to its class.

The spec stays plain Python data, so the proto round trip is structural
identity. Each module keeps its spec and its own weights under the JAX
package's names (NPLSTM: Wx [D,4H], Wh [H,4H], b [4H]; affine: W [ni,no],
b [no]); sub networks live in ``module.sub``. Batches are right-padded
[B, T, D] float32 with int32 ``lengths[B]``.

The image layers of VGSL nets (models/prefab.py ``vgsl``: Tesseract's
line recogniser) carry a column of ``ny`` rows of ``nc`` channels as the
frame's ny·nc features, row-major: ``Conv2D`` (a ky x kx convolution over
rows and frames, zero outside the image, and a nonlinearity),
``MaxPool2D`` (the maximum over non-overlapping ky x kx windows: fewer
frames, so a net's output lengths are its kinds' ``out_lengths``
composed) and ``NPLSTMYSum`` (an LSTM down each column, its last output
kept). In the bf16 mode a lone NPLSTM and Reversed(NPLSTM) run on the
bidi pair's kernels, one direction alone (ops/bidi_lstm_kernel.py,
``params_r`` None).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from clstm_tpu_torch.ops.affine_kernel import (
    affine_bwd, affine_bwd_plain, affine_fwd, affine_fwd_plain)
from clstm_tpu_torch.ops.bidi_lstm_kernel import (
    bidi_lstm_infer, bidi_lstm_train)
from clstm_tpu_torch.ops.lstm import bidi_lstm_apply, lstm_apply
from clstm_tpu_torch.ops.nonlin import nonlin_apply
from clstm_tpu_torch.ops.seq import flip_within_length
from clstm_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class NetSpec:
    """Static description of one network node (reference INetwork sans
    state). ``attr`` is the reference's string->string Assoc, stored as a
    sorted tuple of pairs so the spec is hashable."""

    kind: str
    attr: tuple = ()
    sub: tuple = ()

    @staticmethod
    def make(kind: str, attr: Optional[Mapping] = None,
             sub: Sequence["NetSpec"] = ()) -> "NetSpec":
        items = tuple(sorted((str(k), str(v)) for k, v in (attr or {}).items()))
        return NetSpec(kind=kind, attr=items, sub=tuple(sub))

    def get(self, key: str, default=None):
        for k, v in self.attr:
            if k == key:
                return v
        return default

    def iget(self, key: str, default: Optional[int] = None) -> int:
        v = self.get(key)
        if v is None:
            if default is None:
                raise KeyError(f"{self.kind}: missing int attr {key!r}")
            return default
        return int(v)

    def dget(self, key: str, default: Optional[float] = None) -> float:
        v = self.get(key)
        if v is None:
            if default is None:
                raise KeyError(f"{self.kind}: missing float attr {key!r}")
            return default
        return float(v)

    def with_attr(self, **kw) -> "NetSpec":
        """This node with the attrs ``kw`` set (as strings)."""
        d = dict(self.attr)
        d.update({k: str(v) for k, v in kw.items()})
        return NetSpec.make(self.kind, d, self.sub)


REGISTRY: dict = {}   # kind -> Layer subclass, constructed as module(spec)
_ALIASES: dict = {}


def register_layer(kind: str, module: type, aliases: Sequence[str] = ()):
    REGISTRY[kind] = module
    for a in aliases:
        _ALIASES[a] = kind


def resolve_kind(kind: str) -> str:
    if kind in REGISTRY:
        return kind
    if kind in _ALIASES:
        return _ALIASES[kind]
    raise ValueError(f"unknown layer kind: {kind!r}")


def make_layer(kind: str, attr: Optional[Mapping] = None,
               sub: Sequence[NetSpec] = ()) -> NetSpec:
    """Reference ``make_layer(kind)`` — construct a spec node by kind string."""
    return NetSpec.make(resolve_kind(kind), attr, sub)


def layer(kind: str, ninput: int, noutput: int, args: Optional[Mapping] = None,
          sub: Sequence[NetSpec] = ()) -> NetSpec:
    """Reference ``layer(...)`` combinator helper: build a node and record
    ninput/noutput attrs."""
    attr = dict(args or {})
    attr.setdefault("ninput", ninput)
    attr.setdefault("noutput", noutput)
    return make_layer(kind, attr, sub)


# ---------------------------------------------------------------------------
# Build / init / apply
# ---------------------------------------------------------------------------

# The precision a CUDA tensor takes when none is asked for: the bf16 mode,
# as the JAX package runs its Pallas kernels in bf16 on its accelerator
# (and lax.scan in f32 on the CPU; a CPU tensor here is f32 too). The port
# took it as the card's default once chip_smoke.py's learning check (phase
# 20: bidi on a glyph corpus from three inits, bf16's CER halving within
# 50 steps of f32's and no worse than f32's + 0.02 at twice that step)
# passed on the card (PERF.md §6).
CARD_DEFAULT_BF16 = True


@dataclasses.dataclass(frozen=True)
class ApplyCtx:
    """Flags threaded through the forward pass."""

    logits: bool = False   # make the final SoftmaxLayer emit logits
    # The bidi layers' precision: True the JAX package's production mode
    # (pallas_lstm.py ``xz_bf16=True``: bf16 operands and streams, f32
    # accumulation, bf16 y) with the affine layers on bf16 operands (its
    # ``_affine`` on the TPU); False strict f32; None CARD_DEFAULT_BF16 on
    # a CUDA tensor and f32 on a CPU tensor, unless compute_dtype is set.
    xz_bf16: Optional[bool] = None
    # The JAX package's ``compute_dtype``, torch.bfloat16 (its one use,
    # bench.py's bench_bf16): the scan recipe of ops/lstm.py on every
    # layer, plain on every device, as the JAX package runs it with
    # lax.scan on every backend; the affine layers on bf16 operands. Never
    # combined with xz_bf16=True.
    compute_dtype: Optional[torch.dtype] = None
    # One fused execution of the bidi idiom (the kernels); False runs
    # Parallel(NPLSTM, Reversed(NPLSTM)) as the literal layer tree.
    fuse_bidi: bool = True

    def __post_init__(self):
        if self.compute_dtype not in (None, torch.bfloat16):
            raise ValueError(f"compute_dtype {self.compute_dtype}: the port "
                             "takes torch.bfloat16 (or None)")
        if self.compute_dtype is not None and self.xz_bf16:
            raise ValueError("compute_dtype and xz_bf16=True are two "
                             "precision modes; the JAX package never "
                             "combines them")

    def bf16(self, x: torch.Tensor) -> bool:
        """Whether the layer on ``x`` runs in the bf16 mode (``xz_bf16``)."""
        if self.compute_dtype is not None:
            return False
        if self.xz_bf16 is None:
            return CARD_DEFAULT_BF16 and x.is_cuda
        return bool(self.xz_bf16)


def build_net(spec: NetSpec) -> "Layer":
    """Module tree mirroring the spec tree, weights zero, on the CPU."""
    return REGISTRY[resolve_kind(spec.kind)](spec)


def init_net(spec: NetSpec, generator: torch.Generator,
             device="cpu") -> "Layer":
    """Build the module tree and draw its weights from ``generator`` (a CPU
    generator), preorder: each node's own weights, then its subs."""
    net = build_net(spec)
    for m in net.modules():
        if isinstance(m, Layer):
            m.reset_parameters(generator)
    return net.to(device)


def apply_net(net: "Layer", x: torch.Tensor,
              lengths: Optional[torch.Tensor] = None, *,
              logits: bool = False, inference: bool = False,
              xz_bf16: Optional[bool] = None, compute_dtype=None,
              fuse_bidi: bool = True) -> torch.Tensor:
    """Forward pass: [B, T, D] right-padded batch -> [B, T, O].

    ``logits=True`` makes the outermost SoftmaxLayer return pre-softmax
    logits (the reference's backward_softmax treats the injected delta as
    the pre-activation delta). ``inference=True`` runs the pass without
    autograd — the no-grad forward that prediction runs, where the bidi pair
    takes the inference kernel (K3); with gradients it takes the training
    kernels (K1 forward, K2 backward). A bidi pair whose input is wider
    than its lane-padded hidden size (``hoists_projection``: the second
    layer of ``bidi2``) takes the hoisted projection and K4 in place of K3
    and K1. ``xz_bf16`` picks the precision (``ApplyCtx``): None, the
    default, is CARD_DEFAULT_BF16 on a CUDA tensor and strict f32 on a CPU
    tensor. ``compute_dtype`` (e.g. torch.bfloat16) is the JAX package's
    scan recipe, run by the plain loops on every device (no kernel; it
    raises with ``xz_bf16=True``); ``fuse_bidi=False`` runs a bidi pair as
    the literal layer tree, two plain ``lstm_apply`` loops (no kernel).
    """
    ctx = ApplyCtx(logits=logits, xz_bf16=xz_bf16,
                   compute_dtype=compute_dtype, fuse_bidi=fuse_bidi)
    if inference:
        with torch.no_grad():
            return net(x, lengths, ctx)
    return net(x, lengths, ctx)


def noutput_of(spec: NetSpec) -> int:
    """Output feature dimension of a spec tree."""
    return REGISTRY[resolve_kind(spec.kind)].noutput(spec)


def out_lengths(spec: NetSpec, lengths):
    """The output frames of each line of input ``lengths`` (an int, a numpy
    array or a tensor, returned in its kind): the kinds' maps composed. A
    net that keeps the frame count returns ``lengths`` itself."""
    return REGISTRY[resolve_kind(spec.kind)].out_lengths(spec, lengths)


def frame_stride(spec: NetSpec) -> int:
    """Input frames per output frame: the product of the pools' x sizes (1
    for a net that keeps the frame count)."""
    kind = resolve_kind(spec.kind)
    own = spec.iget("kx") if kind == "MaxPool2D" else 1
    n = 1
    for s in spec.sub:
        n *= frame_stride(s)
    return own * n


def walk_weights(spec: NetSpec, net: "Layer", path: str = ""):
    """Yield (path, name, tensor) over all trainable weights of ``net``
    (the module tree built from ``spec``), preorder — the analogue of the
    reference's weight walker (INetwork::myweights), with the JAX
    package's paths and order."""
    for name, arr in net.weights().items():
        yield path or ".", name, arr
    for i, (s, m) in enumerate(zip(spec.sub, net.sub)):
        yield from walk_weights(s, m, f"{path}/{s.kind}[{i}]")


def network_info(spec: NetSpec, net: Optional["Layer"] = None,
                 indent: int = 0) -> str:
    """Debug dump of the network tree (reference ``network_info``), with
    each node's weight shapes when ``net`` is given: the JAX package's
    text for the same spec and weights."""
    pad = "  " * indent
    attrs = " ".join(f"{k}={v}" for k, v in spec.attr)
    lines = [f"{pad}{spec.kind} {attrs}".rstrip()]
    if net is not None:
        for name, arr in net.weights().items():
            lines.append(f"{pad}  [{name} {tuple(arr.shape)}]")
    for i, s in enumerate(spec.sub):
        lines.append(network_info(s, net.sub[i] if net is not None else None,
                                  indent + 1))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Layer kinds
# ---------------------------------------------------------------------------

_INIT_SCALE = 0.01  # reference uniform init scale (rinit "unif", unverified)


class Layer(nn.Module):
    """One node of the layer tree: its spec, its own weights, its subs."""

    def __init__(self, spec: NetSpec):
        super().__init__()
        self.spec = spec
        self.sub = nn.ModuleList([build_net(s) for s in spec.sub])

    def weights(self) -> dict:
        """This node's own weights by name (not the subs')."""
        return dict(self.named_parameters(recurse=False))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Uniform in [-initial, initial] (reference rinit "unif")."""
        s = self.spec.dget("initial", _INIT_SCALE)
        with torch.no_grad():
            for p in self.weights().values():
                p.uniform_(-s, s, generator=generator)

    @staticmethod
    def noutput(spec: NetSpec) -> int:
        """The kind's output feature dim: the ``noutput`` attr unless the
        kind says otherwise."""
        return spec.iget("noutput")

    @staticmethod
    def out_lengths(spec: NetSpec, lengths):
        """The kind's output frames of input ``lengths``: the same, unless
        the kind says otherwise."""
        return lengths

    def forward(self, x, lengths=None, ctx: ApplyCtx = ApplyCtx()):
        raise NotImplementedError


_NONLIN = {"LinearLayer": "LIN", "SigmoidLayer": "SIG", "TanhLayer": "TANH",
           "ReluLayer": "RELU"}


class _AffineBF16(torch.autograd.Function):
    """x·W + b with bf16 operands, f32 accumulation and an f32 result plus
    the f32 bias: the JAX package's ``_affine`` on its accelerator
    (clstm_tpu/models/spec.py:230-243). Its gradients are those of JAX's
    casts around the product: dW and dx are the f32 products of the f32
    cotangent with the other operand, rounded to bf16 (the operands' type),
    dx then in x's type; db is the f32 sum. With ``kernel`` (the bf16 mode)
    the products are ops/affine_kernel.py's, the bf16 tensor-core kernels
    on a CUDA tensor (the cotangent entering them exactly, as three bf16
    parts) and their plain versions on a CPU tensor; without it (the
    compute_dtype route) they are those plain versions on every device: the
    f32 product of the bf16 operands, exact term by term."""

    @staticmethod
    def forward(ctx, x, W, b, kernel):
        with span("clstm.affine.fwd"):
            x16 = x.to(torch.bfloat16)
            W16 = W.to(torch.bfloat16)
            ctx.save_for_backward(x16, W16)
            ctx.x_dtype = x.dtype
            ctx.kernel = kernel
            fwd = affine_fwd if kernel else affine_fwd_plain
            z = fwd(x16.reshape(-1, x.shape[-1]), W16, b, torch.float32)
            return z.reshape(*x.shape[:-1], W.shape[1])

    @staticmethod
    def backward(ctx, g):
        with span("clstm.affine.bwd"):
            x16, W16 = ctx.saved_tensors
            bwd = affine_bwd if ctx.kernel else affine_bwd_plain
            dx, dW, db = bwd(
                g.reshape(-1, g.shape[-1]).float(),
                x16.reshape(-1, x16.shape[-1]), W16,
                ctx.x_dtype if ctx.needs_input_grad[0] else None,
                ctx.needs_input_grad[1], ctx.needs_input_grad[2])
            if dx is not None:
                dx = dx.reshape(x16.shape)
            return dx, dW, db, None


class Affine(Layer):
    """Full layer: nonlin(x·W + b) (reference forward_full1)."""

    def __init__(self, spec: NetSpec):
        super().__init__(spec)
        ni, no = spec.iget("ninput"), spec.iget("noutput")
        self.W = nn.Parameter(torch.zeros(ni, no))
        self.b = nn.Parameter(torch.zeros(no))

    def affine(self, x: torch.Tensor, bf16: bool = False,
               kernel: bool = False) -> torch.Tensor:
        """x·W + b, f32; with ``bf16`` on bf16 operands (``_AffineBF16``),
        on the kernels of ops/affine_kernel.py where ``kernel``."""
        if bf16:
            return _AffineBF16.apply(x, self.W, self.b, kernel)
        with span("clstm.affine.fwd"):
            return torch.matmul(x.float(), self.W) + self.b

    def affine_ctx(self, x: torch.Tensor, ctx: ApplyCtx) -> torch.Tensor:
        """The affine at ``ctx``'s precision: bf16 operands in the bf16 mode
        (on the kernels) and under ``compute_dtype`` (the JAX package's
        ``_affine`` casts its operands to ``compute_dtype`` on every
        backend; the plain products on every device), else f32."""
        mode = ctx.bf16(x)
        return self.affine(x, mode or ctx.compute_dtype is not None, mode)

    def forward(self, x, lengths=None, ctx: ApplyCtx = ApplyCtx()):
        nl = _NONLIN[resolve_kind(self.spec.kind)]
        return nonlin_apply(nl, self.affine_ctx(x, ctx)).to(x.dtype)


class Softmax(Affine):
    """DTYPE CONTRACT: SoftmaxLayer always returns f32 posteriors/logits,
    regardless of input dtype (bf16 from a bidi layer in the bf16 mode);
    other layer kinds preserve x.dtype."""

    def forward(self, x, lengths=None, ctx: ApplyCtx = ApplyCtx()):
        z = self.affine_ctx(x, ctx)
        if ctx.logits:
            return z
        return torch.softmax(z, dim=-1)


class NPLSTM(Layer):
    @staticmethod
    def noutput(spec: NetSpec) -> int:
        return spec.iget("nhidden")

    def __init__(self, spec: NetSpec):
        super().__init__(spec)
        ni, nh = spec.iget("ninput"), spec.iget("nhidden")
        self.Wx = nn.Parameter(torch.zeros(ni, 4 * nh))
        self.Wh = nn.Parameter(torch.zeros(nh, 4 * nh))
        self.b = nn.Parameter(torch.zeros(4 * nh))

    def forward(self, x, lengths=None, ctx: ApplyCtx = ApplyCtx()):
        if one_direction(ctx, x):
            return _lstm1(self.weights(), x, lengths, ctx, False)
        return lstm_apply(self.weights(), x, lengths,
                          compute_dtype=ctx.compute_dtype)


def one_direction(ctx: ApplyCtx, x: torch.Tensor) -> bool:
    """Whether a lone LSTM (NPLSTM, Reversed(NPLSTM), the column LSTM)
    runs on the kernels, one direction alone (their plain versions on a
    CPU tensor): in the bf16 mode, the one they were built and checked
    for; not under ``compute_dtype`` or ``fuse_bidi=False``, the routes
    that run no kernel. Elsewhere (strict f32, on either device) the plain
    loop ``lstm_apply``."""
    return ctx.fuse_bidi and ctx.bf16(x)


def _lstm1(p: dict, x: torch.Tensor, lengths, ctx: ApplyCtx, reverse: bool,
           spans: bool = True) -> torch.Tensor:
    """One direction on the kernels, in the bf16 mode: trained (K1, K2)
    where a gradient is asked for, else the inference forward."""
    if lengths is not None:
        lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    x = x.contiguous()
    if torch.is_grad_enabled() and (
            x.requires_grad or any(w.requires_grad for w in p.values())):
        return bidi_lstm_train(p, None, x, lengths, True, reverse, spans)
    return bidi_lstm_infer(p, None, x, lengths, xz_bf16=True,
                           reverse=reverse)


class Stacked(Layer):
    @staticmethod
    def noutput(spec: NetSpec) -> int:
        return noutput_of(spec.sub[-1])

    @staticmethod
    def out_lengths(spec: NetSpec, lengths):
        for s in spec.sub:
            lengths = out_lengths(s, lengths)
        return lengths

    def forward(self, x, lengths=None, ctx: ApplyCtx = ApplyCtx()):
        n = len(self.sub)
        for i, s in enumerate(self.sub):
            x = s(x, lengths, dataclasses.replace(
                ctx, logits=ctx.logits and i == n - 1))
            if lengths is not None:
                lengths = out_lengths(s.spec, lengths)
        return x


def _is_bidi_pair(spec: NetSpec) -> bool:
    """Detect the reference bidi idiom Parallel(NPLSTM, Reversed(NPLSTM)) so
    it can dispatch to the fused bidirectional kernel. The spec tree (and so
    the .clstm layout) is unchanged — this is purely an execution-plan
    choice."""
    if len(spec.sub) != 2:
        return False
    a, b = spec.sub
    return (resolve_kind(a.kind) == "NPLSTM"
            and resolve_kind(b.kind) == "Reversed"
            and len(b.sub) == 1
            and resolve_kind(b.sub[0].kind) == "NPLSTM"
            and a.iget("nhidden") == b.sub[0].iget("nhidden"))


class Parallel(Layer):
    @staticmethod
    def noutput(spec: NetSpec) -> int:
        return sum(noutput_of(s) for s in spec.sub)

    @staticmethod
    def out_lengths(spec: NetSpec, lengths):
        return out_lengths(spec.sub[0], lengths) if spec.sub else lengths

    def forward(self, x, lengths=None, ctx: ApplyCtx = ApplyCtx()):
        if ctx.fuse_bidi and _is_bidi_pair(self.spec):
            pf = self.sub[0].weights()
            pr = self.sub[1].sub[0].weights()
            if ctx.compute_dtype is not None:
                # The JAX package's route under compute_dtype on every
                # backend: the one-scan recipe, no kernel.
                return bidi_lstm_apply(pf, pr, x, lengths,
                                       compute_dtype=ctx.compute_dtype)
            mode = {"xz_bf16": True} if ctx.bf16(x) else {}
            if torch.is_grad_enabled() and (
                    x.requires_grad or any(
                        w.requires_grad
                        for w in (*pf.values(), *pr.values()))):
                return bidi_lstm_train(pf, pr, x, lengths, **mode)
            return bidi_lstm_infer(pf, pr, x, lengths, **mode)
        sub_ctx = dataclasses.replace(ctx, logits=False)
        return torch.cat([s(x, lengths, sub_ctx) for s in self.sub], dim=-1)


class Reversed(Layer):
    @staticmethod
    def noutput(spec: NetSpec) -> int:
        return noutput_of(spec.sub[0])

    @staticmethod
    def out_lengths(spec: NetSpec, lengths):
        return out_lengths(spec.sub[0], lengths)

    def forward(self, x, lengths=None, ctx: ApplyCtx = ApplyCtx()):
        if (len(self.sub) == 1 and resolve_kind(self.sub[0].spec.kind)
                == "NPLSTM" and one_direction(ctx, x)):
            return _lstm1(self.sub[0].weights(), x, lengths, ctx, True)
        sub_ctx = dataclasses.replace(ctx, logits=False)
        y = self.sub[0](flip_within_length(x, lengths), lengths, sub_ctx)
        return flip_within_length(y, lengths)


class Botched(Layer):
    @staticmethod
    def noutput(spec: NetSpec) -> int:
        return noutput_of(spec.sub[0]) if spec.sub else 0

    def forward(self, x, lengths=None, ctx: ApplyCtx = ApplyCtx()):
        # Reference ``Botched`` guards partially-implemented nets by aborting
        # in forward/backward.
        raise NotImplementedError(
            "Botched layer: forward is intentionally unimplemented")


# -- image layers (VGSL nets) -------------------------------------------------

def _fwd_span(layer: str):
    """The forward span of an image layer: "conv" or "ysum"."""
    return (span("clstm.conv.fwd") if layer == "conv"
            else span("clstm.ysum.fwd"))


def _bwd_span(layer: str):
    return (span("clstm.conv.bwd") if layer == "conv"
            else span("clstm.ysum.bwd"))


class _Spanned(torch.autograd.Function):
    """``fn(x, *ws)`` inside the forward span of ``layer``, its backward
    (autograd through fn's own graph) inside the backward span: a layer
    whose work is a few library ops keeps its kernels under its own spans,
    the backward's too (utils/profiling.py)."""

    @staticmethod
    def forward(ctx, layer, fn, x, *ws):
        with _fwd_span(layer), torch.enable_grad():
            xd = x.detach().requires_grad_(x.requires_grad)
            wd = [w.detach().requires_grad_(True) for w in ws]
            out = fn(xd, *wd)
        ctx.layer, ctx.graph = layer, (out, xd, wd)
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        out, xd, wd = ctx.graph
        del ctx.graph
        ins = ([xd] if xd.requires_grad else []) + wd
        with _bwd_span(ctx.layer):
            grads = list(torch.autograd.grad(out, ins, g, allow_unused=True))
        dx = grads.pop(0) if xd.requires_grad else None
        return (None, None, dx, *grads)


def _spanned(layer: str, fn, x: torch.Tensor, *ws) -> torch.Tensor:
    """fn(x, *ws) under ``layer``'s spans (``_Spanned``) where a gradient
    is asked for, else fn under its forward span."""
    if torch.is_grad_enabled() and (
            x.requires_grad or any(w.requires_grad for w in ws)):
        return _Spanned.apply(layer, fn, x, *ws)
    with _fwd_span(layer):
        return fn(x, *ws)


def _valid_frames(lengths, B: int, T: int, device) -> Optional[torch.Tensor]:
    """[B, T] bool frame validity, None for all frames valid."""
    if lengths is None:
        return None
    return (torch.arange(T, device=device)[None, :]
            < lengths.to(device)[:, None])


_TORCH_NONLIN = {"TANH": torch.tanh, "SIG": torch.sigmoid,
                 "RELU": torch.relu, "LIN": lambda z: z}


class Conv2D(Layer):
    """A ky x kx convolution over a column of ``ny`` rows of ``nc``
    channels and its frames (VGSL ``C``; Tesseract's Convolve, which stacks
    each pixel's neighbourhood with zeros outside the image, then a fully
    connected layer): ``nfilters`` outputs a pixel, then ``nonlin``
    (TANH, SIG, RELU or LIN). W [ky·kx·nc, nfilters] (rows by (dy, dx, c)),
    b [nfilters]; frames [B, T, ny·nc] -> [B, T, ny·nfilters], exactly 0 on
    padded frames, which read as zeros. In the bf16 mode bf16 operands
    (and bias) with f32 accumulation, the output rounded to bf16 (a
    library convolution: torch's)."""

    @staticmethod
    def noutput(spec: NetSpec) -> int:
        return spec.iget("ny") * spec.iget("nfilters")

    def __init__(self, spec: NetSpec):
        super().__init__(spec)
        ky, kx = spec.iget("ky"), spec.iget("kx")
        nc, nf = spec.iget("nc"), spec.iget("nfilters")
        self.W = nn.Parameter(torch.zeros(ky * kx * nc, nf))
        self.b = nn.Parameter(torch.zeros(nf))

    def forward(self, x, lengths=None, ctx: ApplyCtx = ApplyCtx()):
        sp = self.spec
        ny, nc, nf = sp.iget("ny"), sp.iget("nc"), sp.iget("nfilters")
        ky, kx = sp.iget("ky"), sp.iget("kx")
        nl = _TORCH_NONLIN[sp.get("nonlin", "TANH").upper()]
        bf16 = ctx.bf16(x) or ctx.compute_dtype is not None
        B, T, _ = x.shape
        valid = _valid_frames(lengths, B, T, x.device)

        def fn(x, W, b):
            if valid is not None:
                x = torch.where(valid[..., None], x, torch.zeros_like(x))
            img = x.reshape(B, T, ny, nc).permute(0, 3, 1, 2)  # [B,nc,T,ny]
            w = W.reshape(ky, kx, nc, nf).permute(3, 2, 1, 0)  # [nf,nc,kx,ky]
            if bf16:
                img, w, b = (t.to(torch.bfloat16) for t in (img, w, b))
            else:
                img = img.float()
            z = F.conv2d(img, w, b, padding=(kx // 2, ky // 2))
            y = nl(z).permute(0, 2, 3, 1)                        # [B,T,ny,nf]
            if valid is not None:
                y = torch.where(valid[..., None, None], y,
                                torch.zeros_like(y))
            return y.reshape(B, T, ny * nf)

        return _spanned("conv", fn, x, self.W, self.b)


class MaxPool2D(Layer):
    """The maximum over non-overlapping ky x kx windows of a column of
    ``ny`` rows of ``nc`` channels and its frames (VGSL ``Mp``): [B, T,
    ny·nc] -> [B, ceil(T/kx), ceil(ny/ky)·nc]. A partial window is pooled
    over its part inside the image and the line (padded frames are left
    out); an output frame past ceil(len/kx) is 0."""

    @staticmethod
    def noutput(spec: NetSpec) -> int:
        return (-(-spec.iget("ny") // spec.iget("ky"))) * spec.iget("nc")

    @staticmethod
    def out_lengths(spec: NetSpec, lengths):
        kx = spec.iget("kx")
        return (lengths + (kx - 1)) // kx

    def forward(self, x, lengths=None, ctx: ApplyCtx = ApplyCtx()):
        sp = self.spec
        ny, nc, ky, kx = (sp.iget("ny"), sp.iget("nc"), sp.iget("ky"),
                          sp.iget("kx"))
        B, T, _ = x.shape
        valid = _valid_frames(lengths, B, T, x.device)
        To = -(-T // kx)
        ovalid = _valid_frames(None if lengths is None else
                               self.out_lengths(sp, lengths), B, To,
                               x.device)

        def fn(x):
            img = x.reshape(B, T, ny, nc)
            if valid is not None:
                img = img.masked_fill(~valid[..., None, None], float("-inf"))
            p = F.max_pool2d(img.permute(0, 3, 1, 2), (kx, ky), (kx, ky),
                             ceil_mode=True).permute(0, 2, 3, 1)
            if ovalid is not None:
                p = torch.where(ovalid[..., None, None], p,
                                torch.zeros_like(p))
            return p.reshape(B, To, -1)

        return _spanned("conv", fn, x)


class NPLSTMYSum(Layer):
    """An LSTM down each column of ``ny`` rows of ``nc`` channels (VGSL
    ``Lfys``: the rows as its steps, top to bottom), keeping its last
    output: [B, T, ny·nc] -> [B, T, nhidden]. The weights and cell are
    NPLSTM's (Wx [nc, 4H]); the B·T columns run as one batch of ny-step
    sequences, a padded frame's column of length 0 (no recurrence, output
    0). On the one-direction kernels as a lone NPLSTM runs, under its own
    spans clstm.ysum.*."""

    @staticmethod
    def noutput(spec: NetSpec) -> int:
        return spec.iget("nhidden")

    def __init__(self, spec: NetSpec):
        super().__init__(spec)
        nc, nh = spec.iget("nc"), spec.iget("nhidden")
        self.Wx = nn.Parameter(torch.zeros(nc, 4 * nh))
        self.Wh = nn.Parameter(torch.zeros(nh, 4 * nh))
        self.b = nn.Parameter(torch.zeros(4 * nh))

    def forward(self, x, lengths=None, ctx: ApplyCtx = ApplyCtx()):
        ny, nc = self.spec.iget("ny"), self.spec.iget("nc")
        B, T, _ = x.shape
        if lengths is None:
            lens = torch.full((B * T,), ny, dtype=torch.int32,
                              device=x.device)
        else:
            lens = (_valid_frames(lengths, B, T, x.device).reshape(-1)
                    .to(torch.int32) * ny)
        kernels = one_direction(ctx, x)
        cd = ctx.compute_dtype

        def fn(x, Wx, Wh, b):
            p = {"Wx": Wx, "Wh": Wh, "b": b}
            cols = x.reshape(B * T, ny, nc)
            y = (_lstm1(p, cols, lens, ctx, False, spans=False) if kernels
                 else lstm_apply(p, cols, lens, compute_dtype=cd))
            return y[:, -1].reshape(B, T, -1)

        return _spanned("ysum", fn, x, self.Wx, self.Wh, self.b)


for _kind, _al in (("LinearLayer", "linear"), ("SigmoidLayer", "sigmoid"),
                   ("TanhLayer", "tanh"), ("ReluLayer", "relu")):
    register_layer(_kind, Affine, (_al,))
register_layer("SoftmaxLayer", Softmax, ("softmax",))
register_layer("NPLSTM", NPLSTM, ("lstm", "LSTM"))
register_layer("Stacked", Stacked, ("stacked",))
register_layer("Parallel", Parallel, ("parallel",))
register_layer("Reversed", Reversed, ("reversed",))
register_layer("Botched", Botched)
register_layer("Conv2D", Conv2D, ("conv2d",))
register_layer("MaxPool2D", MaxPool2D, ("maxpool2d",))
register_layer("NPLSTMYSum", NPLSTMYSum, ("lstmysum",))
