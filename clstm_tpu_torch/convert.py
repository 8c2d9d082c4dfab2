"""Weights and training state carried between the JAX package and the
port.

The JAX package keeps a net's weights as a params pytree mirroring the spec
tree, ``{"weights": {name: array}, "sub": [child trees]}``; the port keeps
them as the parameters of the module tree built from the same spec. Both use
the same names and layouts (NPLSTM: Wx [D,4H], Wh [H,4H], b [4H]; affine:
W [ni,no], b [no]), so conversion is a copy through numpy, exact in float32.
A TrainState's velocity has the params' tree shape in the JAX package and is
keyed by parameter name in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from clstm_tpu_torch.models.spec import Layer, NetSpec, build_net
from clstm_tpu_torch.train import TrainState


def _arrays(net: Layer, tree: dict, path: str = ".",
            prefix: str = "") -> dict:
    """A params-shaped tree -> float32 numpy arrays keyed by parameter name
    (``net.named_parameters()``), checked against the module tree."""
    own = net.weights()
    given = tree["weights"]
    if set(own) != set(given):
        raise ValueError(f"{path}: {net.spec.kind} has weights {sorted(own)}, "
                         f"tree has {sorted(given)}")
    out = {}
    for name, p in own.items():
        arr = np.asarray(given[name], np.float32)
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{path}/{name}: shape {arr.shape}, "
                             f"expected {tuple(p.shape)}")
        out[prefix + name] = arr
    if len(tree["sub"]) != len(net.sub):
        raise ValueError(f"{path}: {len(net.sub)} subs, tree has "
                         f"{len(tree['sub'])}")
    for i, (s, t) in enumerate(zip(net.sub, tree["sub"])):
        out.update(_arrays(s, t, f"{path}/{s.spec.kind}[{i}]",
                           f"{prefix}sub.{i}."))
    return out


def _tree(net: Layer, values: dict, prefix: str = "") -> dict:
    """Tensors keyed by parameter name -> a params-shaped tree of float32
    numpy arrays."""
    return {"weights": {name: values[prefix + name].detach().cpu().numpy()
                        for name in net.weights()},
            "sub": [_tree(s, values, f"{prefix}sub.{i}.")
                    for i, s in enumerate(net.sub)]}


def params_from_numpy(spec: NetSpec, tree: dict, device="cpu") -> Layer:
    """Params pytree (arrays as numpy) -> the port's module tree on
    ``device``."""
    net = build_net(spec)
    arrays = _arrays(net, tree)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.tensor(arrays[name]))
    return net.to(device)


def params_to_numpy(net: Layer) -> dict:
    """The port's module tree -> params pytree of float32 numpy arrays."""
    return _tree(net, dict(net.named_parameters()))


def state_from_numpy(spec: NetSpec, params: dict, velocity: dict, step,
                     device="cpu") -> TrainState:
    """A JAX TrainState's fields as numpy (params and velocity pytrees, the
    step) -> the port's TrainState on ``device``."""
    net = params_from_numpy(spec, params, device)
    vel = {name: torch.tensor(arr, device=device)
           for name, arr in _arrays(net, velocity).items()}
    return TrainState(net=net, velocity=vel, step=int(np.asarray(step)))


def state_to_numpy(state: TrainState):
    """The port's TrainState -> (params, velocity, step): two pytrees of
    float32 numpy arrays and an int32 scalar, the fields of a JAX
    TrainState."""
    return (params_to_numpy(state.net), _tree(state.net, state.velocity),
            np.asarray(state.step, np.int32))
