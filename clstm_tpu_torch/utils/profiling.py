"""Profiling/tracing helpers (port of clstm_tpu/utils/profiling.py).

The reference has no profiler — only wall-clock ``now()`` prints
(SURVEY.md §5). ``trace()`` wraps ``torch.profiler`` where the JAX package
wraps ``jax.profiler``, and writes a Chrome trace (chrome://tracing,
Perfetto or TensorBoard's profiler plugin); ``Throughput`` provides the
lines/sec counters the train CLIs report.

``span(name)`` marks a layer boundary of the training path (the names and
their layers are ``SPANS``): a ``torch.profiler.record_function`` while a
profiler records, so the span lies on the profiler's timeline beside the
kernels it launched, and a shared no-op otherwise. ``span_account`` reads
a Chrome trace back: every kernel put down to the innermost span that
launched it, each span's device time, a step's own host time and where
the card idled.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import socket
import time
import warnings

import torch

# Every span of the port, by name -> the layer it marks (PERF.md section 3).
# Every span() call names one of these (tests/test_torch_spans.py).
SPANS = {
    "clstm.block": "CLI loop",          # models/hl.py train_batch_block
    "clstm.step": "step",               # train.py, one per training step
    "clstm.gather": "data",             # train.py gather_batch
    "clstm.plan": "data",               # data/device_cache.py _epoch_plans
    "clstm.lstm.fwd": "kernels",        # ops/bidi_lstm_kernel.py
    "clstm.lstm.bwd": "kernels",        # _BidiLSTMTrain
    "clstm.affine.fwd": "affine",       # models/spec.py _AffineBF16, Affine
    "clstm.affine.bwd": "affine",
    "clstm.hoist": "affine",            # ops/lstm.py hoisted_projection
    "clstm.ctc": "alignment",           # ops/ctc.py ctc_align_targets_batched
    "clstm.loss": "step glue",          # train.py the softmax and loss tail
    "clstm.backward": "step glue",      # train.py loss.backward()
    "clstm.update": "step glue",        # train.py apply_update
    "clstm.report": "step glue",        # train.py greedy_frames, HostCopy
    "clstm.report.wait": "CLI loop",    # utils/config.py HostCopy.numpy
    "clstm.decode": "CLI loop",         # ops/ctc.py decode_frames
}

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking the span ``name`` (a key of SPANS): while
    a torch.profiler session records, ``torch.profiler.record_function``
    (on the profiler's clock, so each kernel's launch can be found inside
    it); otherwise the shared no-op, which enters nothing, allocates
    nothing and makes no CUDA call."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace around a code block; on exit it is
    written to ``logdir`` as ``<host>_<pid>.<ns>.pt.trace.json``. Yields
    the profiler; on exit it also holds ``trace_path`` and the trace's
    ``kernel_records`` and ``kernel_launches`` (kernel_counts).

    CPU activity always; CUDA activity (the kernels on the card) when CUDA
    is available. Where the trace holds fewer kernel records than kernel
    launches, a RuntimeWarning says so: on the H100 a session late in a
    long process that had profiled before lost the records of its first
    kernels (their launches were recorded; PERF.md section 7), so a short
    trace is never returned silently."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    with prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
        ".pt.trace.json")
    prof.export_chrome_trace(prof.trace_path)
    prof.kernel_records, prof.kernel_launches = kernel_counts(
        prof.trace_path)
    if prof.kernel_records < prof.kernel_launches:
        warnings.warn(f"{prof.trace_path} holds {prof.kernel_records} kernel "
                      f"records of {prof.kernel_launches} kernel launches: "
                      "the profiler lost the rest", RuntimeWarning,
                      stacklevel=3)


def kernel_counts(path: str) -> tuple:
    """A Chrome trace written by ``trace`` -> (its kernel records, its
    kernel launches: the CUDA runtime and driver calls that launch one)."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    return (sum(e.get("cat") == "kernel" for e in events),
            sum(e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "") for e in events))


def _union(intervals) -> list:
    """Sorted, disjoint [start, end] lists covering the same points."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _covered(union: list, s: float, e: float) -> float:
    """How much of [s, e] the sorted, disjoint intervals ``union`` cover."""
    i = max(bisect.bisect_right(union, [s]) - 1, 0)
    got = 0.0
    while i < len(union) and union[i][0] < e:
        got += max(0.0, min(e, union[i][1]) - max(s, union[i][0]))
        i += 1
    return got


def _minus(a: list, b: list) -> list:
    """The sorted, disjoint intervals ``a`` less ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


# What the host was inside while the card idled, by the span that marks
# it; the first that covers a moment takes it (a report inside a step is
# the step's), and "other" (the caller's own code, the edges of the traced
# stretch) takes the rest.
IDLE_UNDER = ("clstm.step", "clstm.plan", "clstm.report",
              "clstm.report.wait", "clstm.decode", "clstm.block")


def span_account(events: list, window: str = "") -> dict:
    """The kernels of a torch.profiler Chrome trace (``trace``'s file's
    ``traceEvents``) put down to the ``clstm.*`` spans that launched them.

    A kernel belongs to the innermost span, on the thread of its launching
    CUDA runtime or driver call (found by the kernel's ``correlation``),
    that is open when that call starts; where no span on that thread is
    open, to the innermost one open on any thread (on the card the
    autograd engine's thread runs a backward while the main thread waits
    inside ``clstm.backward``). A kernel whose launch is in no span, or not
    in the trace, is unattributed.

    ``window`` names an event (the benchmark's ``portbench.window``) whose
    interval bounds the account: a kernel counts by its part inside it.
    Without one the window runs from the first span or kernel to the last.

    -> {"window_us", "busy_us", "spans": [(name, tid, start, end)],
    "kernels": [(name, start, dur, span or None)], "device_us" and
    "launches": {span: the device us and the number of the kernels put
    down to it}, "unattributed_us", "step_host_us": [each ``clstm.step``'s
    duration less the part of it that CUDA runtime and driver calls of any
    host thread cover: the host's own work in the step], "idle_us":
    {IDLE_UNDER's names and "other": the window's time in which no kernel
    ran, by the span the host was in}}. Times in microseconds."""
    spans, calls, kernels, w = [], [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if window and name == window and w is None:
            w = (s, s + d)
        elif cat == "user_annotation" and name.startswith("clstm."):
            spans.append((name, e.get("tid"), s, s + d))
        elif cat in ("cuda_runtime", "cuda_driver"):
            calls.append((s, s + d, e.get("tid"),
                          e.get("args", {}).get("correlation")))
        elif cat == "kernel":
            kernels.append((name, s, d,
                            e.get("args", {}).get("correlation")))
    if w is None:
        ends = [(s, t) for _, _, s, t in spans] + [
            (s, s + d) for _, s, d, _ in kernels]
        w = (min(s for s, _ in ends), max(t for _, t in ends)) if ends else (
            0.0, 0.0)
    # One sweep in time order: each thread's open spans nest, so the
    # innermost is the top of its stack.
    marks = [(s, 0, -t, i) for i, (_, _, s, t) in enumerate(spans)]
    marks += [(t, 2, 0, i) for i, (_, _, _, t) in enumerate(spans)]
    marks += [(c[0], 1, 0, i) for i, c in enumerate(calls)]
    stacks, owner = {}, {}
    for _, kind, _, i in sorted(marks):
        if kind == 0:
            stacks.setdefault(spans[i][1], []).append(i)
        elif kind == 2:
            st = stacks.get(spans[i][1], [])
            if i in st:
                st.remove(i)
        else:
            st = stacks.get(calls[i][2])
            if not st:
                tops = [v[-1] for v in stacks.values() if v]
                st = [max(tops, key=lambda j: spans[j][2])] if tops else []
            if st:
                owner[calls[i][3]] = spans[st[-1]][0]
    w0, w1 = w
    out, device_us, launches, lost = [], {}, {}, 0.0
    for name, s, d, corr in kernels:
        a, b = max(s, w0), min(s + d, w1)
        if b <= a:
            continue
        sp = owner.get(corr)
        out.append((name, a, b - a, sp))
        if sp is None:
            lost += b - a
        else:
            device_us[sp] = device_us.get(sp, 0.0) + b - a
            launches[sp] = launches.get(sp, 0) + 1
    busy = _union((s, s + d) for _, s, d, _ in out)
    idle = _minus([[w0, w1]], busy) if w1 > w0 else []
    idle_us = {}
    for cat in IDLE_UNDER:
        under = _union((s, t) for n, _, s, t in spans if n == cat)
        idle_us[cat] = sum(_covered(under, s, t) for s, t in idle)
        idle = _minus(idle, under)
    idle_us["other"] = sum(t - s for s, t in idle)
    cuda = _union((s, t) for s, t, _, _ in calls)
    step_host = [(t - s) - _covered(cuda, s, t)
                 for n, _, s, t in spans if n == "clstm.step"]
    return {"window_us": w1 - w0, "busy_us": sum(t - s for s, t in busy),
            "spans": spans, "kernels": out, "device_us": device_us,
            "launches": launches, "unattributed_us": lost,
            "step_host_us": step_host, "idle_us": idle_us}


class Throughput:
    """Sliding throughput meter (items/sec over the recent window)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.events: list = []  # (t, count)
        self.total = 0

    def add(self, n: int = 1) -> None:
        self.total += n
        self.events.append((time.time(), n))
        if len(self.events) > self.window:
            self.events.pop(0)

    def rate(self) -> float:
        if len(self.events) < 2:
            return 0.0
        dt = self.events[-1][0] - self.events[0][0]
        n = sum(c for _, c in self.events[1:])
        return n / dt if dt > 0 else 0.0


class Timer:
    """Reference utils.h ``now()``-style wall-clock timing."""

    def __init__(self):
        self.t0 = time.time()

    def elapsed(self) -> float:
        return time.time() - self.t0
