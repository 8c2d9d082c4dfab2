#!/usr/bin/env python3
"""What CUDA_MODULE_LOADING=EAGER costs the port when it takes the card.

    python3 scripts/torch_module_loading_probe.py [--reps N]

With lazy module loading (CUDA's default) a kernel's module is loaded at
its first launch, and a cuBLAS f32 product at a new shape can then wait for
the card (scripts/torch_blas_wait_probe.py). EAGER loads every module when
the context is made. This probe measures, in fresh child processes, N of
each setting in turns (lazy, eager, eager, lazy, ...):

  init_s     seconds from the process's first CUDA call to a usable card
             (torch.zeros(1, device="cuda") and a synchronize, the import
             of torch excluded);
  used_mib   device memory in use after that call (total - free, from
             torch.cuda.mem_get_info: the context and the loaded modules);
  first_mm_s seconds of the first f32 product after it ([4503, 400] x
             [400, 1600], the shape that waited under lazy loading).

Prints the card, one JSON line per child, then the medians per setting
and EAGER's extra cost over lazy. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def child() -> None:
    import torch

    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    free, total = torch.cuda.mem_get_info()
    a = torch.rand(4503, 400, device="cuda")
    w = torch.rand(400, 1600, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a @ w
    torch.cuda.synchronize()
    print(json.dumps({
        "loading": os.environ.get("CUDA_MODULE_LOADING", "LAZY"),
        "init_s": init_s, "used_mib": (total - free) / 2 ** 20,
        "first_mm_s": time.perf_counter() - t0}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    runs = {"LAZY": [], "EAGER": []}
    order = []
    for _ in range(args.reps):
        order += ["LAZY", "EAGER", "EAGER", "LAZY"]
    for mode in order:
        env = dict(os.environ, CUDA_MODULE_LOADING=mode)
        out = subprocess.run([sys.executable, __file__, "--child"], env=env,
                             capture_output=True, text=True, check=True)
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        runs[mode].append(rec)
    med = {m: {k: statistics.median(r[k] for r in rs)
               for k in ("init_s", "used_mib", "first_mm_s")}
           for m, rs in runs.items()}
    print(json.dumps({"median": med, "eager_extra": {
        k: med["EAGER"][k] - med["LAZY"][k]
        for k in ("init_s", "used_mib", "first_mm_s")}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:
        child()
        sys.exit(0)
    sys.exit(main())
