"""Prefab network constructors (port of clstm_tpu/models/prefab.py).

Reference: clstm_prefab.cc (≈L1-200, unverified) — ``make_net(kind, Assoc)``
builds the standard architectures by name; ``make_net_init`` also
initializes. Kinds and attr names (ninput/nhidden/noutput) match the
reference so configs and .clstm files carry over.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional, Tuple

import torch

from clstm_tpu_torch.models.spec import (
    Layer, NetSpec, init_net, layer, make_layer, resolve_kind)


def _ii(args: Mapping, key: str, default: Optional[int] = None) -> int:
    v = args.get(key, default)
    if v is None:
        raise KeyError(f"make_net: missing arg {key!r}")
    return int(v)


def _bidi_block(ninput: int, nhidden: int, extra: Mapping) -> NetSpec:
    """Parallel(NPLSTM, Reversed(NPLSTM)): ninput -> 2*nhidden."""
    fwd = layer("NPLSTM", ninput, nhidden, {"nhidden": nhidden, **extra})
    rev = layer("Reversed", ninput, nhidden, {}, [
        layer("NPLSTM", ninput, nhidden, {"nhidden": nhidden, **extra})])
    return layer("Parallel", ninput, 2 * nhidden, {}, [fwd, rev])


def make_net(kind: str, args: Optional[Mapping] = None) -> NetSpec:
    """Build a prefab network spec by kind name (reference make_net)."""
    args = dict(args or {})
    extra = {}
    if "initial" in args:
        extra["initial"] = args["initial"]

    if kind in ("linear", "sigmoid", "tanh", "relu", "softmax"):
        ni, no = _ii(args, "ninput"), _ii(args, "noutput")
        return layer(kind, ni, no, extra)

    if kind == "lstm1":
        ni, nh, no = _ii(args, "ninput"), _ii(args, "nhidden"), _ii(args, "noutput")
        return layer("Stacked", ni, no, {}, [
            layer("NPLSTM", ni, nh, {"nhidden": nh, **extra}),
            layer("SoftmaxLayer", nh, no, extra),
        ])

    if kind == "revlstm1":
        ni, nh, no = _ii(args, "ninput"), _ii(args, "nhidden"), _ii(args, "noutput")
        return layer("Stacked", ni, no, {}, [
            layer("Reversed", ni, nh, {}, [
                layer("NPLSTM", ni, nh, {"nhidden": nh, **extra})]),
            layer("SoftmaxLayer", nh, no, extra),
        ])

    if kind == "bidi":
        ni, nh, no = _ii(args, "ninput"), _ii(args, "nhidden"), _ii(args, "noutput")
        return layer("Stacked", ni, no, {}, [
            _bidi_block(ni, nh, extra),
            layer("SoftmaxLayer", 2 * nh, no, extra),
        ])

    if kind == "bidi2":
        ni, nh, no = _ii(args, "ninput"), _ii(args, "nhidden"), _ii(args, "noutput")
        nh2 = _ii(args, "nhidden2", nh)
        return layer("Stacked", ni, no, {}, [
            _bidi_block(ni, nh, extra),
            _bidi_block(2 * nh, nh2, extra),
            layer("SoftmaxLayer", 2 * nh2, no, extra),
        ])

    if kind == "vgsl":
        return vgsl_net(str(args.get("spec", "")), _ii(args, "ninput"),
                        _ii(args, "noutput"), extra)

    # Fall back to a bare registered layer kind.
    return make_layer(kind, args)


# VGSL (Tesseract's Variable-size Graph Specification Language, tessdoc's
# "VGSL specs") as far as Tesseract 4/5's line recognisers use it: the input
# [b,h,w,d] (h the line's height, d 1), C<nl><y>,<x>,<d> (a y x x
# convolution of d filters, nl one of s t r l), Mp<y>,<x> (max-pool),
# Lfys<n> (an LSTM down each column, summarised to its last output),
# L(f|r|b)x<n> (an LSTM along x: forward, reversed, or both), O1(c|s)<n>
# (the softmax output; n is the codec's size, whatever the string says).
_NONLIN = {"s": "SIG", "t": "TANH", "r": "RELU", "l": "LIN"}


def vgsl_net(spec: str, ninput: int, noutput: int,
             extra: Optional[Mapping] = None) -> NetSpec:
    """The net of a VGSL string, e.g. Tesseract's ``eng`` recogniser
    "[1,36,0,1 Ct3,3,16 Mp3,3 Lfys64 Lfx96 Lrx96 Lfx512 O1c1]": a Stacked
    tree of Conv2D, MaxPool2D, NPLSTMYSum, NPLSTM, Reversed(NPLSTM) (and
    the bidi pair for Lbx) and a SoftmaxLayer of ``noutput`` classes, the
    string kept in the root's ``vgsl`` attr. The input's height must be
    ``ninput`` (the line's rows; one channel). Raises ValueError on
    anything else of the language."""
    extra = dict(extra or {})
    toks = spec.strip().strip("[]").split()
    if not toks:
        raise ValueError("vgsl: an empty spec")
    shape = [int(v) for v in toks[0].split(",")]
    if len(shape) != 4 or shape[1] != ninput or shape[3] != 1:
        raise ValueError(f"vgsl: the input {toks[0]!r} must be "
                         f"[b,{ninput},w,1] (the line's rows, one channel)")
    ny, nc = ninput, 1
    layers = []

    def width():
        return ny * nc
    for tok in toks[1:]:
        m = re.fullmatch(r"C([strl])(\d+),(\d+),(\d+)", tok)
        if m:
            ky, kx, nf = (int(v) for v in m.groups()[1:])
            layers.append(layer("Conv2D", width(), ny * nf, {
                "ny": ny, "nc": nc, "ky": ky, "kx": kx, "nfilters": nf,
                "nonlin": _NONLIN[m.group(1)], **extra}))
            nc = nf
            continue
        m = re.fullmatch(r"Mp(\d+),(\d+)", tok)
        if m:
            ky, kx = (int(v) for v in m.groups())
            nyo = -(-ny // ky)
            layers.append(layer("MaxPool2D", width(), nyo * nc, {
                "ny": ny, "nc": nc, "ky": ky, "kx": kx}))
            ny = nyo
            continue
        m = re.fullmatch(r"Lfys(\d+)", tok)
        if m:
            nh = int(m.group(1))
            layers.append(layer("NPLSTMYSum", width(), nh, {
                "ny": ny, "nc": nc, "nhidden": nh, **extra}))
            ny, nc = 1, nh
            continue
        m = re.fullmatch(r"L([frb])x(\d+)", tok)
        if m:
            if ny != 1:
                raise ValueError(f"vgsl: {tok} needs a summarised column "
                                 f"(height 1), not {ny}")
            d, nh = m.group(1), int(m.group(2))
            ni = width()
            lstm = layer("NPLSTM", ni, nh, {"nhidden": nh, **extra})
            if d == "f":
                layers.append(lstm)
            elif d == "r":
                layers.append(layer("Reversed", ni, nh, {}, [lstm]))
            else:
                layers.append(_bidi_block(ni, nh, extra))
            nc = 2 * nh if d == "b" else nh
            continue
        m = re.fullmatch(r"O1([cs])(\d+)", tok)
        if m and tok is toks[-1]:
            if ny != 1:
                raise ValueError(f"vgsl: {tok} needs a summarised column")
            layers.append(layer("SoftmaxLayer", width(), noutput, extra))
            nc = noutput
            continue
        raise ValueError(f"vgsl: {tok!r} is not a layer this port builds")
    if not layers or resolve_kind(layers[-1].kind) != "SoftmaxLayer":
        raise ValueError("vgsl: the spec must end in an O1c output layer")
    return layer("Stacked", ninput, noutput, {"vgsl": spec}, layers)


def make_net_init(kind: str, args: Optional[Mapping] = None,
                  generator: Optional[torch.Generator] = None,
                  device="cpu") -> Tuple[NetSpec, Layer]:
    """Reference make_net_init: construct + initialize. Without a generator,
    one is seeded from the ``randseed`` arg (default 0)."""
    spec = make_net(kind, args)
    if generator is None:
        generator = torch.Generator().manual_seed(
            int(dict(args or {}).get("randseed", 0)))
    return spec, init_net(spec, generator, device)
