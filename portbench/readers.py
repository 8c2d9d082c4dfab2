"""Arithmetic shared by the per-layer metric readers (portbench/metrics/):
each reader is a file of its own that calls one of these on the run's
context, and returns None where it finds nothing to read."""

from __future__ import annotations

from portbench import bounds
from portbench.trace import layer_ms


def roofline_pct(ctx: dict, layer: str):
    """Σ of the bound ms of the layer's work over the traced steps, over Σ
    of the device ms of the kernels the kernel entries give to the layer,
    in %. The bound functions are those the layer's entries name."""
    if "trace" not in ctx:
        return None
    entries = {k: v for k, v in ctx["kernels"].items()
               if v["layer"] == layer}
    ms = layer_ms(ctx["trace"], entries, layer)
    if ms <= 0:
        return None
    cfg = ctx["run"].cfg
    fns = {v["bound"] for v in entries.values()}
    bound = sum(bounds.STEP_BOUNDS[f](cfg, st) for f in fns
                for st in ctx["steps"])
    return 100.0 * bound / ms


def idle_pct(ctx: dict):
    """The share of the traced window no kernel covers, in %."""
    tr = ctx.get("trace")
    if not tr or tr["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / tr["window_us"])


def mfu_pct(ctx: dict, train: bool):
    """The matrix flop of the window's valid frames over the window, over
    the card's peak for the configuration's precision, in %."""
    import torch
    w = ctx["window"]
    if not w.get("valid_frames") or not w.get("seconds"):
        return None
    cfg = ctx["run"].cfg
    pk = bounds.peaks(torch.cuda.get_device_name(0))
    peak = pk["bf16_flops"] if cfg["precision"] == "bf16" else pk[
        "f32_mma_flops"]
    flop = bounds.flop_per_frame(cfg, train) * w["valid_frames"]
    return 100.0 * flop / w["seconds"] / peak
