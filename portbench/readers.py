"""Arithmetic shared by the per-layer metric readers (portbench/metrics/):
each reader is a file of its own that calls one of these on the run's
context, and returns None where it finds nothing to read. The work is
priced by the configuration's family (bounds.step_bound,
``flop_per_frame``)."""

from __future__ import annotations

from portbench import bounds
from portbench.trace import layer_ms


def _bound_ms(ctx: dict, fns) -> float:
    """Σ over the traced steps of the bound functions ``fns``."""
    run = ctx["run"]
    return sum(bounds.step_bound(run.fam, f)(run.cfg, st) for f in fns
               for st in ctx["steps"])


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
    return 100.0 * _bound_ms(ctx, {v["bound"] for v in entries.values()}) / ms


def span_roofline_pct(ctx: dict, spans, bound: str):
    """Σ of the bound ms of ``bound``'s work over the traced steps, over Σ
    of the device ms of the kernels put down to ``spans`` (the program's
    spans that launched them: trace.parse), in %."""
    tr = ctx.get("trace")
    if not tr:
        return None
    ms = sum(tr["span_us"].get(s, 0.0) for s in spans) * 1e-3
    if ms <= 0:
        return None
    return 100.0 * _bound_ms(ctx, [bound]) / ms


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
    run = ctx["run"]
    pk = bounds.peaks(torch.cuda.get_device_name(0))
    peak = pk["bf16_flops"] if run.cfg["precision"] == "bf16" else pk[
        "f32_mma_flops"]
    flop = run.fam.flop_per_frame(run.cfg, train) * w["valid_frames"]
    return 100.0 * flop / w["seconds"] / peak
