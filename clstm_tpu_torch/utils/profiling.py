"""Profiling/tracing helpers (port of clstm_tpu/utils/profiling.py).

The reference has no profiler — only wall-clock ``now()`` prints
(SURVEY.md §5). ``trace()`` wraps ``torch.profiler`` where the JAX package
wraps ``jax.profiler``, and writes a Chrome trace (chrome://tracing,
Perfetto or TensorBoard's profiler plugin); ``Throughput`` provides the
lines/sec counters the train CLIs report.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
import warnings

import torch


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
