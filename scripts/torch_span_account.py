#!/usr/bin/env python3
"""Where a training block's card and host time go, by the port's spans
(clstm_tpu_torch/utils/profiling.py: SPANS, span_account).

    python3 scripts/torch_span_account.py --workload bidi.train --seed 7

Builds one cell of the benchmark (portbench/: its configuration, corpus,
weights and warm-up), then runs its traced stretch (``--blocks`` blocks,
by default the mix's ``trace_blocks``, of clstmocrtrain's loop from a
fresh feed, the deferred reports read and decoded) four times, from four
feeds of one plan (``--plan``): untraced, traced, untraced, traced, each
from a synchronised card to a synchronised card on the host's clock. The
first traced stretch's Chrome trace is read back and put down to the
spans. Prints one JSON object (also written, with ``kernels``, to
chiprun_out/span_account_<workload>.<blocks>.json):

  card, power_limit       the card's name and power limit (nvidia-smi)
  buckets, steps          the traced blocks' T buckets and their steps
  records, launches       the trace's kernel records and kernel launches
  window_ms, busy_ms      the traced window and the union of its kernels
  per_step                each span's device ms and kernel launches a step
  kernels                 each span's kernels by name: ms and launches a
                          step (the JSON file only)
  unattributed_us         device us of kernels under no span
  attributed_pct          the share of the window's kernel time under one
  step_ms                 a clstm.step span's duration (mean, min, max)
  step_host_ms            a step's own host time: a clstm.step's duration
                          less the CUDA runtime and driver calls within it
                          (mean over the steps; min, max)
  idle_pct                the window's idle share by the span the host was
                          in (profiling.IDLE_UNDER; "other": the harness's
                          own code and the stretch's edges)
  affine_roofline_pct     the affine layer's bound (softmax forward, dx,
                          dW; the hoisted product's forward where the layer
                          hoists) over the device ms of the kernels under
                          clstm.affine.* and clstm.hoist
  glue_device_pct         device ms under clstm.gather, .loss, .update,
                          .report and directly under .backward, over busy
  stretch_s               the four stretches' host seconds
  tracing_overhead_pct    mean traced over mean untraced, less 1

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GLUE = ("clstm.gather", "clstm.loss", "clstm.update", "clstm.report",
        "clstm.backward")
AFFINE = ("clstm.affine.fwd", "clstm.affine.bwd", "clstm.hoist")


def affine_bound_ms(cfg: dict, st: dict) -> float:
    """The bound of one training step's affine work: the softmax layer's
    forward z = [x|1]·W, dx = dz·Wᵀ and dW = xᵀ·dz, and the hoisted input
    product's forward (where the layer hoists). Flop and reads at the V
    valid frames, writes at all B·T, operands at the configuration's
    precision, z and dz f32 (portbench/bounds.py's pricing)."""
    from portbench import bounds
    pk = bounds.peaks("H100")
    e = 2 if cfg["precision"] == "bf16" else 4
    peak = pk["bf16_flops"] if e == 2 else pk["f32_mma_flops"]
    hbm = pk["hbm_bytes_per_s"]
    B, T, V = st["B"], st["T"], st["V"]
    X, C = 2 * cfg["nhidden_layers"][-1], cfg["noutput"]
    works = [
        (2 * V * (X + 1) * C, e * (V * X + (X + 1) * C) + 4 * B * T * C),
        (2 * V * C * X, 4 * V * C + e * X * C + e * B * T * X),
        (2 * V * X * C, e * V * X + 4 * V * C + 4 * (X + 1) * C)]
    for D, H in bounds.layers(cfg):
        if bounds.hoists(D, H):
            works.append((2 * V * (D + 1) * 8 * H,
                          e * (V * D + (D + 1) * 8 * H + B * T * 8 * H)))
    return sum(bounds.bound(f, b, peak, hbm)[0] for f, b in works)


def card() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    name, _, limit = out.partition(",")
    return {"card": name.strip(), "power_limit": limit.strip()}


def main() -> int:
    import numpy as np
    import torch

    from clstm_tpu_torch.utils import profiling
    from portbench import harness, registry
    from portbench.trace import kernel_name, parse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--blocks", type=int, default=0)
    p.add_argument("--plan", type=int, default=2,
                   help="the feeds' plan seed, past the mix's plan_seed")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    harness.set_caches()
    man = registry.manifest()
    run = harness.Run(man, args.workload, argparse.Namespace(
        seed=args.seed, seconds=0.0, trace=1), "cuda")
    drv = registry.driver(run.mix["driver"])
    st = drv.setup(run)
    ocr, K = st["ocr"], st["K"]
    n = args.blocks or run.mix["trace_blocks"]

    def stretch(feed):
        rep = drv._Reports(ocr, run.mix["report_every"])
        steps = []
        for _ in range(n):
            block = next(feed)
            with torch.profiler.record_function("portbench.train_block"):
                m = ocr.train_batch_block(block, k_max=K)
            with torch.profiler.record_function("portbench.report"):
                rep.add(m, block)
            steps += drv._step_records(block)
        with torch.profiler.record_function("portbench.report"):
            rep.flush()
        return steps

    def feed():
        return st["dcache"].epoch_blocks(
            st["B"], K,
            rng=np.random.RandomState(run.mix["plan_seed"] + args.plan),
            epochs=K)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    secs, events, steps = [], None, None
    for traced in (False, True, False, True):
        f = feed()
        torch.cuda.synchronize()
        if not traced:
            t0 = time.perf_counter()
            stretch(f)
            torch.cuda.synchronize()
            secs.append((traced, time.perf_counter() - t0))
            continue
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("portbench.window"):
                t0 = time.perf_counter()
                got = stretch(f)
                torch.cuda.synchronize()
                secs.append((traced, time.perf_counter() - t0))
        if events is None:
            steps = got
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "t.json")
                prof.export_chrome_trace(path)
                with open(path, encoding="utf-8") as fh:
                    events = json.load(fh)["traceEvents"]
    tr = parse(events)
    acc = profiling.span_account(events, window="portbench.window")
    ns = len(steps)
    dev, lau = acc["device_us"], acc["launches"]
    kernel_us = sum(d for _, _, d, _ in acc["kernels"])
    host = acc["step_host_us"]
    span_us = [t - s for name, _, s, t in acc["spans"]
               if name == "clstm.step"]
    by = {}
    for name, _, d, sp in acc["kernels"]:
        k = by.setdefault(sp, {}).setdefault(kernel_name(name), [0.0, 0])
        k[0] += d * 1e-3 / ns
        k[1] += 1 / ns
    affine_ms = sum(dev.get(s, 0.0) for s in AFFINE) * 1e-3
    bound = sum(affine_bound_ms(run.cfg, s) for s in steps)
    win = acc["window_us"]
    t_un = np.mean([s for t, s in secs if not t])
    t_tr = np.mean([s for t, s in secs if t])
    out = dict(card(), workload=args.workload, seed=args.seed,
               buckets=sorted({s["T"] for s in steps}), steps=ns,
               records=tr["records"], launches=tr["launches"],
               window_ms=win * 1e-3, busy_ms=acc["busy_us"] * 1e-3,
               parse_busy_ms=tr["busy_us"] * 1e-3,
               per_step={s: {"device_ms": dev[s] * 1e-3 / ns,
                             "launches": lau[s] / ns}
                         for s in sorted(dev, key=lambda k: -dev[k])},
               unattributed_us=acc["unattributed_us"],
               attributed_pct=100.0 * (1 - acc["unattributed_us"]
                                       / kernel_us),
               step_ms=[float(np.mean(span_us)) * 1e-3,
                        min(span_us) * 1e-3, max(span_us) * 1e-3],
               step_host_ms=[float(np.mean(host)) * 1e-3,
                             min(host) * 1e-3, max(host) * 1e-3],
               idle_pct={k: 100.0 * v / win
                         for k, v in acc["idle_us"].items()},
               affine_roofline_pct=100.0 * bound / affine_ms,
               glue_device_pct=100.0 * sum(dev.get(s, 0.0) for s in GLUE)
               / acc["busy_us"],
               stretch_s=[[("traced" if t else "untraced"), s]
                          for t, s in secs],
               tracing_overhead_pct=100.0 * (t_tr / t_un - 1))
    print(json.dumps(out), flush=True)
    out["kernels"] = {str(sp): sorted(ks.items(), key=lambda kv: -kv[1][0])
                      for sp, ks in by.items()}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"span_account_{args.workload}.{n}.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
