"""Training-state checkpoints (.npz sidecar; port of
clstm_tpu/io/checkpoint.py).

The reference's .clstm format stores the model but no optimizer state. The
sidecar holds the full TrainState (params, velocity, step) as a flat .npz
keyed by the JAX package's pytree paths — ``params['sub'][0]['weights']
['Wx']``, ``velocity...``, ``step`` — so a sidecar written by either
package resumes in the other.
"""

from __future__ import annotations

import numpy as np

from clstm_tpu_torch.convert import state_from_numpy, state_to_numpy
from clstm_tpu_torch.models.spec import Layer
from clstm_tpu_torch.train import TrainState


def _flatten(tree: dict, path: str = "") -> dict:
    out = {f"{path}['weights']['{name}']": arr
           for name, arr in tree["weights"].items()}
    for i, sub in enumerate(tree["sub"]):
        out.update(_flatten(sub, f"{path}['sub'][{i}]"))
    return out


def _unflatten(net: Layer, z, path: str) -> dict:
    return {"weights": {name: z[f"{path}['weights']['{name}']"]
                        for name in net.weights()},
            "sub": [_unflatten(s, z, f"{path}['sub'][{i}]")
                    for i, s in enumerate(net.sub)]}


def save_state(fname: str, state: TrainState) -> None:
    params, velocity, step = state_to_numpy(state)
    flat = {}
    flat.update(_flatten(params, "params"))
    flat.update(_flatten(velocity, "velocity"))
    flat["step"] = step
    np.savez(fname, **flat)


def load_state(fname: str, template: TrainState) -> TrainState:
    """Restore into the structure of ``template`` and onto its device. A
    missing key raises KeyError, a shape mismatch ValueError."""
    net = template.net
    device = next(net.parameters()).device
    with np.load(fname) as z:
        return state_from_numpy(net.spec, _unflatten(net, z, "params"),
                                _unflatten(net, z, "velocity"), z["step"],
                                device)
