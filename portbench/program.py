"""What the benchmark takes from the program (clstm_tpu_torch): the model
object its CLIs build, set up with the benchmark's own weights and
character table, and its launch counters. Nothing here computes a result
the benchmark judges."""

from __future__ import annotations

import importlib
import pkgutil

import torch

from portbench import corpus


def codec(nglyphs: int):
    """The program's Codec for classes 0 (blank) and 1..nglyphs."""
    from clstm_tpu_torch.models.codec import Codec
    return Codec([0] + [ord(c) for c in corpus.charset(nglyphs)])


def model(cfg: dict, fam, weights: list, device: str):
    """A CLSTMOCR of the configuration, as the CLIs build it (createBidi
    with the prefab kind cfg["net"] and the family's arguments), with the
    benchmark's weights copied into its parameters by the family's names,
    and the configuration's precision."""
    from clstm_tpu_torch.models.hl import CLSTMOCR
    ocr = CLSTMOCR(target_height=cfg["ninput"], dewarp=cfg["dewarp"],
                   device=device)
    ocr.createBidi(codec(cfg["noutput"] - 1), kind=cfg["net"],
                   **fam.build_args(cfg))
    params = dict(ocr.net.named_parameters())
    names = fam.program_names(cfg)
    if set(names.values()) != set(params):
        raise RuntimeError("the program's net has other parameters than "
                           f"the configuration: {sorted(params)}")
    with torch.no_grad():
        for n, t in fam.leaves(weights).items():
            params[names[n]].copy_(t)
    ocr.xz_bf16 = cfg["precision"] == "bf16"
    return ocr


def launch_counts() -> dict:
    """Every launch counter of the program's kernel wrappers: each function
    of a ``clstm_tpu_torch.ops`` module that carries ``launches`` (keyed by
    its name) or ``launches16`` (``<name>.launches16``)."""
    import clstm_tpu_torch.ops as ops
    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for fn in vars(mod).values():
            if getattr(fn, "__module__", None) != mod.__name__:
                continue
            for attr in ("launches", "launches16"):
                n = getattr(fn, attr, None)
                if isinstance(n, int):
                    key = fn.__name__ if attr == "launches" else (
                        f"{fn.__name__}.{attr}")
                    out[key] = n
    return out
