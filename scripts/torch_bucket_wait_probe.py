#!/usr/bin/env python3
"""Where a training step of the port waits for the card at a T bucket it
has not run before.

    python3 scripts/torch_bucket_wait_probe.py

A bidi net (48 inputs, 100 units, 96 classes) takes make_train_step steps
at B=32 over clstmocrtrain's T buckets, each bucket first behind a long
device sleep (torch.cuda._sleep); a step that returns only after the sleep
waited for the card. A step still running at a quarter of the sleep has
the host's Python stacks dumped (faulthandler); the innermost frames of
the main thread are printed beside the caching allocator's segment count
before and after the step. One child process per setting:

  default       the card's default precision (bf16 xz_bf16);
  f32           xz_bf16=False;
  gc off        Python's cyclic garbage collector disabled;
  pregrown      the allocator's pools grown first (an 8 GiB block and 1 GiB
                of 512 KiB blocks taken and freed, so they stay cached);
  expandable    PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True.

Then, in a child of its own, the depth of the card's launch queue: behind
the same sleep, the host launches small kernels until one launch blocks
(the queue is full, and the host waits for the card to take entries from
it); and how many kernels, copies and fills one clstmocrtrain block of
K=8 such steps at T=256 puts in that queue (make_multi_train_step, counted
with utils/profiling.trace in that fresh process).

Prints the card, then per setting the buckets at which a step waited and
where, then the queue's depth and the block's entries. Needs one CUDA
card.
"""

from __future__ import annotations

import faulthandler
import os
import subprocess
import sys
import tempfile
import time

SETTINGS = {
    "default": {},
    "f32": {"PROBE_F32": "1"},
    "gc off": {"PROBE_GC_OFF": "1"},
    "pregrown": {"PROBE_PREGROW": "1"},
    "expandable": {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"},
}
BUCKETS = (1536, 1024, 640, 160, 768, 192, 256, 128, 512, 384, 448, 1280,
           896, 224)
SLEEP_CYCLES = 2 * 10 ** 9
DUMP_FRAMES = 4


def main_frames(text: str) -> list:
    """The innermost DUMP_FRAMES frames of the thread that runs child(), in
    a faulthandler dump."""
    for block in text.split("\nThread ")[1:] or [text]:
        if "in child" in block:
            frames = [ln.strip() for ln in block.splitlines()
                      if ln.startswith("  File ")]
            return frames[:DUMP_FRAMES]
    return []


def child() -> None:
    import gc

    import numpy as np
    import torch

    from clstm_tpu_torch.models.prefab import make_net_init
    from clstm_tpu_torch.ops.ctc import mktargets_ids
    from clstm_tpu_torch.train import TrainState, make_train_step
    from clstm_tpu_torch.utils.config import torch_device

    if os.environ.get("PROBE_GC_OFF"):
        gc.disable()
    dev = torch_device("cuda")
    B, D, H, C, nchars = 32, 48, 100, 96, 12
    spec, net = make_net_init("bidi", {"ninput": D, "nhidden": H,
                                       "noutput": C},
                              torch.Generator().manual_seed(0), dev)
    step = make_train_step(spec, 1e-6, 0.9,
                           xz_bf16=False if os.environ.get("PROBE_F32")
                           else None)
    state = TrainState.create(net)
    rng = np.random.RandomState(0)

    def batch(T):
        tids = np.stack([mktargets_ids(rng.randint(1, C, size=nchars))
                         for _ in range(B)]).astype(np.int32)
        b = {"x": rng.rand(B, T, D).astype(np.float32),
             "lengths": np.full(B, T - 7, np.int32), "targets": tids,
             "target_lengths": np.full(B, 2 * nchars + 1, np.int32)}
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    batches = {T: batch(T) for T in BUCKETS}
    if os.environ.get("PROBE_PREGROW"):
        big = torch.empty(8 << 30, dtype=torch.uint8, device=dev)
        small = [torch.empty(512 << 10, dtype=torch.uint8, device=dev)
                 for _ in range(2048)]
        del big, small
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    torch.cuda.synchronize()
    sleep_ms = start.elapsed_time(end)
    waited = []
    with tempfile.TemporaryFile("w+") as dump:
        for T in BUCKETS:
            segs = torch.cuda.memory_stats().get("segment.all.current", 0)
            torch.cuda._sleep(SLEEP_CYCLES)
            dump.seek(0)
            dump.truncate()
            faulthandler.dump_traceback_later(sleep_ms / 4e3, file=dump)
            t0 = time.perf_counter()
            step(state, batches[T])
            ms = (time.perf_counter() - t0) * 1e3
            faulthandler.cancel_dump_traceback_later()
            torch.cuda.synchronize()
            segs2 = torch.cuda.memory_stats().get("segment.all.current", 0)
            if ms > 0.5 * sleep_ms:
                dump.seek(0)
                where = main_frames(dump.read())
                waited.append(T)
                print(f"  T={T}: {ms:.1f} ms, segments {segs} -> {segs2}; "
                      f"main thread at: {' <- '.join(where)}", flush=True)
            else:
                print(f"  T={T}: {ms:.1f} ms, segments {segs} -> {segs2}",
                      flush=True)
    print(f"  sleep {sleep_ms:.1f} ms; waited at {len(waited)} of "
          f"{len(BUCKETS)} new buckets: {waited}", flush=True)


def queue_child() -> None:
    import json

    import numpy as np
    import torch

    from clstm_tpu_torch.models.prefab import make_net_init
    from clstm_tpu_torch.ops.ctc import mktargets_ids
    from clstm_tpu_torch.train import TrainState, make_multi_train_step
    from clstm_tpu_torch.utils.config import torch_device
    from clstm_tpu_torch.utils.profiling import trace

    dev = torch_device("cuda")
    a = torch.zeros(1, device=dev)
    a.add_(1)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    depth = None
    for i in range(1, 1 << 16):
        t0 = time.perf_counter()
        a.add_(1)
        if time.perf_counter() - t0 > 0.1:
            depth = i
            break
    torch.cuda.synchronize()
    print(f"  behind a device sleep, launch {depth} was the first to block "
          "(queue full)", flush=True)
    K, B, T, D, H, C, nchars = 8, 32, 256, 48, 100, 96, 12
    spec, net = make_net_init("bidi", {"ninput": D, "nhidden": H,
                                       "noutput": C},
                              torch.Generator().manual_seed(0), dev)
    step = make_multi_train_step(spec, K, 1e-6, 0.9)
    state = TrainState.create(net)
    rng = np.random.RandomState(0)
    n = K * B
    tids = np.stack([mktargets_ids(rng.randint(1, C, size=nchars))
                     for _ in range(n)]).astype(np.int32)
    group = {k: torch.from_numpy(v).to(dev) for k, v in {
        "x": rng.rand(n, T, D).astype(np.float32),
        "lengths": np.full(n, T - 7, np.int32), "targets": tids,
        "tlens": np.full(n, 2 * nchars + 1, np.int32)}.items()}
    idx_all = torch.arange(n, device=dev).reshape(K, B)
    step(state, group, idx_all, 0)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            step(state, group, idx_all, 0)
        with open(prof.trace_path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    runtime = [e.get("name", "") for e in events
               if e.get("cat") == "cuda_runtime"]
    copies = sum("Memcpy" in r for r in runtime)
    fills = sum("Memset" in r for r in runtime)
    print(f"  one K={K} block at B={B} T={T}: {prof.kernel_launches} kernel "
          f"launches ({prof.kernel_records} recorded), {copies} copies, "
          f"{fills} fills", flush=True)


def main() -> int:
    if os.environ.get("PROBE_CHILD") == "queue":
        queue_child()
        return 0
    if os.environ.get("PROBE_CHILD"):
        child()
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), "| torch", torch.__version__, "cuda",
        torch.version.cuda, flush=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from clstm_tpu_torch.ops import _build
    _build.build()
    rc = 0
    for name, env in list(SETTINGS.items()) + [
            ("launch queue", {"PROBE_CHILD": "queue"})]:
        print(f"{name}:", flush=True)
        rc |= subprocess.run(
            [sys.executable, os.path.abspath(__file__)], cwd=root,
            env={**os.environ, "PROBE_CHILD": "1", **env,
                 "PYTHONPATH": root}).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
