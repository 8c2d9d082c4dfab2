"""Network graph layer: NetSpec + one nn.Module per layer kind, prefabs,
codec and the high-level OCR and text APIs (port of clstm_tpu/models).

Exports the JAX package's names but ``LayerDef``: its registry entry holds
a kind's init, apply and noutput functions, where the port registers the
kind's ``nn.Module`` class (models/spec.py says why).
"""

from clstm_tpu_torch.models.spec import (
    NetSpec,
    REGISTRY,
    register_layer,
    make_layer,
    init_net,
    apply_net,
    network_info,
    walk_weights,
)
from clstm_tpu_torch.models.prefab import make_net, make_net_init
from clstm_tpu_torch.models.codec import Codec

__all__ = [
    "NetSpec",
    "REGISTRY",
    "register_layer",
    "make_layer",
    "init_net",
    "apply_net",
    "network_info",
    "walk_weights",
    "make_net",
    "make_net_init",
    "Codec",
]
