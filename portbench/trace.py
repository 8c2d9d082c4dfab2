"""The device trace of a traced window, reduced to what the per-layer
readers take: each kernel's name and interval, the union of the kernel
intervals (the card busy), the longest gaps between them with what the
host was doing, and the kernels that took the most time.

torch.profiler records the window (CPU and CUDA activity); its Chrome
trace is written under the temporary directory, read back and deleted.
The harness's own spans (torch.profiler.record_function around each call
into the program) name the host's work in the gaps.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings

import torch


def kernel_name(name: str) -> str:
    """A profiler kernel name without ``void``, the anonymous namespace and
    the arguments; template arguments are kept."""
    name = name.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    return name.split("(")[0]


def profile(fn):
    """Run ``fn()`` under torch.profiler, the card synchronised at both
    ends -> (fn's result, the parsed trace ``parse`` gives)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("portbench.window"):
            out = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, parse(events)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def parse(events: list) -> dict:
    """Chrome trace events -> {"kernels": [(name, start_us, dur_us)],
    "window_us", "busy_us", "gaps": [(start_us, end_us, host)],
    "launches", "records"}. The window is the harness's span
    ``portbench.window``; a kernel counts by its part inside it."""
    win = [e for e in events if e.get("name") == "portbench.window"
           and e.get("ph") == "X"]
    if not win:
        raise RuntimeError("the trace has no portbench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    kernels, host = [], []
    launches = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "kernel":
            s, t = max(ts, w0), min(ts + dur, w1)
            if t > s:
                kernels.append((kernel_name(e["name"]), s, t - s))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime",
                     "cuda_driver"):
            if e["name"] != "portbench.window":
                host.append((e["name"], ts, ts + dur))
            if "LaunchKernel" in e["name"] or "LaunchCooperative" in e[
                    "name"]:
                launches += 1
    merged = _union((s, s + d) for _, s, d in kernels)
    busy = sum(e - s for s, e in merged)
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(s, e, _host_in(host, s, e)) for s, e in gaps[:10]]
    if len(kernels) < launches:
        warnings.warn(f"the trace holds {len(kernels)} kernel records of "
                      f"{launches} launches", RuntimeWarning)
    return {"kernels": kernels, "window_us": w1 - w0, "busy_us": busy,
            "gaps": named, "launches": launches, "records": len(kernels)}


def _host_in(host: list, s: float, e: float) -> str:
    """What the host did in [s, e): the shortest host event that covers at
    least half of it, else the one that covers most of it."""
    half, most = None, None
    for name, hs, he in host:
        ov = min(he, e) - max(hs, s)
        if ov <= 0:
            continue
        if ov >= 0.5 * (e - s) and (half is None or he - hs < half[1]):
            half = (name, he - hs)
        if most is None or ov > most[1]:
            most = (name, ov)
    if half is not None:
        return half[0]
    return most[0] if most is not None else "host idle"


def breakdown(tr: dict) -> dict:
    """The ten kernels that took most device time and the ten longest idle
    gaps, [[name, seconds], ...]."""
    by = {}
    for name, _, d in tr["kernels"]:
        by[name] = by.get(name, 0.0) + d
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, d * 1e-6] for n, d in ops],
            "idle_gaps": [[h, (e - s) * 1e-6] for s, e, h in tr["gaps"]]}


def layer_ms(tr: dict, entries: dict, layer: str) -> float:
    """Device ms of the kernels the entries give to ``layer``."""
    prefixes = [k["prefix"] for k in entries.values() if k["layer"] == layer]
    return sum(d for name, _, d in tr["kernels"]
               if any(name.startswith(p) for p in prefixes)) * 1e-3
