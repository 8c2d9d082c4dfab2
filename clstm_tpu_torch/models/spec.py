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
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from clstm_tpu_torch.ops.bidi_lstm_kernel import (
    bidi_lstm_infer, bidi_lstm_train)
from clstm_tpu_torch.ops.lstm import bidi_lstm_apply, lstm_apply
from clstm_tpu_torch.ops.nonlin import nonlin_apply
from clstm_tpu_torch.ops.seq import flip_within_length


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
    dx then in x's type; db is the f32 sum. Each product is the f32 product
    of the bf16 operands, which is exact, so it is bf16 operands with f32
    accumulation; cuBLAS's bf16 kernels would wait for the card at the
    first use of each of them, which new batch shapes bring
    (ops/lstm.py::hoisted_projection)."""

    @staticmethod
    def forward(ctx, x, W, b):
        x16 = x.to(torch.bfloat16)
        W16 = W.to(torch.bfloat16)
        ctx.save_for_backward(x16, W16)
        ctx.x_dtype = x.dtype
        lead = x.shape[:-1]
        z = x16.reshape(-1, x.shape[-1]).float() @ W16.float() + b
        return z.reshape(*lead, W.shape[1])

    @staticmethod
    def backward(ctx, g):
        x16, W16 = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        x2 = x16.reshape(-1, x16.shape[-1])
        dx = dW = db = None
        if ctx.needs_input_grad[0]:
            dx = (g2 @ W16.float().t()).to(torch.bfloat16).to(
                ctx.x_dtype).reshape(x16.shape)
        if ctx.needs_input_grad[1]:
            dW = (x2.float().t() @ g2).to(torch.bfloat16).float()
        if ctx.needs_input_grad[2]:
            db = g2.sum(0)
        return dx, dW, db


class Affine(Layer):
    """Full layer: nonlin(x·W + b) (reference forward_full1)."""

    def __init__(self, spec: NetSpec):
        super().__init__(spec)
        ni, no = spec.iget("ninput"), spec.iget("noutput")
        self.W = nn.Parameter(torch.zeros(ni, no))
        self.b = nn.Parameter(torch.zeros(no))

    def affine(self, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
        """x·W + b, f32; with ``bf16`` on bf16 operands (``_AffineBF16``)."""
        if bf16:
            return _AffineBF16.apply(x, self.W, self.b)
        return torch.matmul(x.float(), self.W) + self.b

    def affine_ctx(self, x: torch.Tensor, ctx: ApplyCtx) -> torch.Tensor:
        """The affine at ``ctx``'s precision: bf16 operands in the bf16 mode
        and under ``compute_dtype`` (the JAX package's ``_affine`` casts its
        operands to ``compute_dtype`` on every backend), else f32."""
        return self.affine(x, ctx.bf16(x) or ctx.compute_dtype is not None)

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
        return lstm_apply(self.weights(), x, lengths,
                          compute_dtype=ctx.compute_dtype)


class Stacked(Layer):
    @staticmethod
    def noutput(spec: NetSpec) -> int:
        return noutput_of(spec.sub[-1])

    def forward(self, x, lengths=None, ctx: ApplyCtx = ApplyCtx()):
        n = len(self.sub)
        for i, s in enumerate(self.sub):
            x = s(x, lengths, dataclasses.replace(
                ctx, logits=ctx.logits and i == n - 1))
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

    def forward(self, x, lengths=None, ctx: ApplyCtx = ApplyCtx()):
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


for _kind, _al in (("LinearLayer", "linear"), ("SigmoidLayer", "sigmoid"),
                   ("TanhLayer", "tanh"), ("ReluLayer", "relu")):
    register_layer(_kind, Affine, (_al,))
register_layer("SoftmaxLayer", Softmax, ("softmax",))
register_layer("NPLSTM", NPLSTM, ("lstm", "LSTM"))
register_layer("Stacked", Stacked, ("stacked",))
register_layer("Parallel", Parallel, ("parallel",))
register_layer("Reversed", Reversed, ("reversed",))
register_layer("Botched", Botched)
