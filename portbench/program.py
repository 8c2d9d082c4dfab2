"""What the benchmark takes from the program (clstm_tpu_torch): the model
object its CLIs build, set up with the benchmark's own weights and
character table, and its launch counters. Nothing here computes a result
the benchmark judges."""

from __future__ import annotations

import torch

from portbench import corpus
from portbench.reference.train import leaves


def codec(nglyphs: int):
    """The program's Codec for classes 0 (blank) and 1..nglyphs."""
    from clstm_tpu_torch.models.codec import Codec
    return Codec([0] + [ord(c) for c in corpus.charset(nglyphs)])


def program_leaf_names(cfg: dict) -> dict:
    """The reference's leaf names -> the program's parameter names
    (Stacked[Parallel(NPLSTM, Reversed(NPLSTM)) ..., SoftmaxLayer])."""
    out = {}
    n = len(cfg["nhidden_layers"])
    for i in range(n):
        for d, path in (("fwd", f"sub.{i}.sub.0"),
                        ("rev", f"sub.{i}.sub.1.sub.0")):
            for w in ("Wx", "Wh", "b"):
                out[f"L{i}.{d}.{w}"] = f"{path}.{w}"
    out["out.W"] = f"sub.{n}.W"
    out["out.b"] = f"sub.{n}.b"
    return out


def model(cfg: dict, weights: list, device: str):
    """A CLSTMOCR of the configuration, as the CLIs build it, with the
    benchmark's weights copied into its parameters and the configuration's
    precision."""
    from clstm_tpu_torch.models.hl import CLSTMOCR
    ocr = CLSTMOCR(target_height=cfg["ninput"], dewarp=cfg["dewarp"],
                   device=device)
    hs = cfg["nhidden_layers"]
    extra = {"nhidden2": hs[1]} if len(hs) > 1 else {}
    ocr.createBidi(codec(cfg["noutput"] - 1), hs[0], kind=cfg["net"],
                   **extra)
    params = dict(ocr.net.named_parameters())
    names = program_leaf_names(cfg)
    ref = leaves(weights)
    if set(names.values()) != set(params):
        raise RuntimeError("the program's net has other parameters than "
                           f"the configuration: {sorted(params)}")
    with torch.no_grad():
        for n, t in ref.items():
            params[names[n]].copy_(t)
    ocr.xz_bf16 = cfg["precision"] == "bf16"
    return ocr


def launch_counts() -> dict:
    """The program's kernel launch counters (the wrappers' ``launches``)."""
    from clstm_tpu_torch.ops import bidi_lstm_kernel as lk
    from clstm_tpu_torch.ops import ctc_kernel as ck
    fns = (lk.bidi_lstm_infer, lk.bidi_lstm_fwd_state, lk.bidi_lstm_infer_xz,
           lk.bidi_lstm_fwd_state_xz, lk.bidi_lstm_bwd_chain,
           lk.bidi_lstm_bwd_reduce, ck.ctc_forward, ck.ctc_both,
           ck.ctc_backward)
    return {f.__name__: f.launches for f in fns}
