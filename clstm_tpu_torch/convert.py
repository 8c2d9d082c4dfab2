"""Weights carried between the JAX package and the port.

The JAX package keeps a net's weights as a params pytree mirroring the spec
tree, ``{"weights": {name: array}, "sub": [child trees]}``; the port keeps
them as the parameters of the module tree built from the same spec. Both use
the same names and layouts (NPLSTM: Wx [D,4H], Wh [H,4H], b [4H]; affine:
W [ni,no], b [no]), so conversion is a copy through numpy, exact in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from clstm_tpu_torch.models.spec import Layer, NetSpec, build_net


def _fill(net: Layer, tree: dict, path: str) -> None:
    own = net.weights()
    given = tree["weights"]
    if set(own) != set(given):
        raise ValueError(f"{path}: {net.spec.kind} has weights {sorted(own)}, "
                         f"tree has {sorted(given)}")
    with torch.no_grad():
        for name, p in own.items():
            arr = np.asarray(given[name], np.float32)
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{path}/{name}: shape {arr.shape}, "
                                 f"expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    if len(tree["sub"]) != len(net.sub):
        raise ValueError(f"{path}: {len(net.sub)} subs, tree has "
                         f"{len(tree['sub'])}")
    for i, (s, t) in enumerate(zip(net.sub, tree["sub"])):
        _fill(s, t, f"{path}/{s.spec.kind}[{i}]")


def params_from_numpy(spec: NetSpec, tree: dict, device="cpu") -> Layer:
    """Params pytree (arrays as numpy) -> the port's module tree on
    ``device``."""
    net = build_net(spec)
    _fill(net, tree, ".")
    return net.to(device)


def params_to_numpy(net: Layer) -> dict:
    """The port's module tree -> params pytree of float32 numpy arrays."""
    return {"weights": {name: p.detach().cpu().numpy()
                        for name, p in net.weights().items()},
            "sub": [params_to_numpy(s) for s in net.sub]}
