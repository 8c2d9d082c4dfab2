"""Prefab network constructors (port of clstm_tpu/models/prefab.py).

Reference: clstm_prefab.cc (≈L1-200, unverified) — ``make_net(kind, Assoc)``
builds the standard architectures by name; ``make_net_init`` also
initializes. Kinds and attr names (ninput/nhidden/noutput) match the
reference so configs and .clstm files carry over.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from clstm_tpu_torch.models.spec import (
    Layer, NetSpec, init_net, layer, make_layer)


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

    # Fall back to a bare registered layer kind.
    return make_layer(kind, args)


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
