#!/usr/bin/env python3
"""Which cuBLAS products of the port's shapes wait for the card at a shape
they have not run before.

    python3 scripts/torch_blas_wait_probe.py

Each product is called behind a long device sleep (torch.cuda._sleep) at
row counts M that the process has not run before; a call that returns
only after the sleep waited for the card. One child process per setting:
the defaults, CUDA_MODULE_LOADING=EAGER, a 64 MiB cuBLAS and cuBLASLt
workspace, the cuBLASLt back end, and bf16 reduced-precision reductions
allowed. The products, each run once at M=2400 before the sweep:

  mm_bf16_f32      torch.mm of bf16 operands with an f32 result, [M, 200]
                   x [200, 96] (bidi's affine layer);
  addmm_bf16       a bf16 addmm, [M, 400] x [400, 1600] + bias (bidi2's
                   hoisted input projection);
  f32_of_bf16      the f32 product of the bf16-rounded operands at the
                   affine's shape (what the port's bf16 mode takes);
  f32_of_bf16_proj the same at the projection's shape.

Prints the card, then per setting the row counts at which each product
waited. Needs one CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

SETTINGS = {
    "default": {},
    "eager module loading": {"CUDA_MODULE_LOADING": "EAGER"},
    "64 MiB workspaces": {"CUBLAS_WORKSPACE_CONFIG": ":65536:2",
                          "CUBLASLT_WORKSPACE_SIZE": "65536"},
    "cuBLASLt back end": {"PROBE_BLAS": "cublaslt"},
    "reduced-precision reductions": {"PROBE_REDUCED": "1"},
}
ROWS = [300 * b for b in range(9, 33)] + [7777, 12345, 65536, 262144]
SLEEP_CYCLES = 5 * 10 ** 8


def child() -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
        os.environ.get("PROBE_REDUCED") == "1")
    if os.environ.get("PROBE_BLAS"):
        torch.backends.cuda.preferred_blas_library(os.environ["PROBE_BLAS"])
    dev = torch.device("cuda")
    W = torch.rand(200, 96, device=dev).bfloat16()
    Wp = torch.rand(400, 1600, device=dev).bfloat16()
    bp = torch.rand(1600, device=dev).bfloat16()
    products = {
        "mm_bf16_f32": (200, lambda a: torch.mm(a, W,
                                                out_dtype=torch.float32)),
        "addmm_bf16": (400, lambda a: torch.addmm(bp, a, Wp)),
        "f32_of_bf16": (200, lambda a: a.float() @ W.float()),
        "f32_of_bf16_proj": (400, lambda a: torch.addmm(
            bp.float(), a.float(), Wp.float())),
    }

    def behind(fn, a) -> float:
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        fn(a)
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return ms

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    torch.cuda.synchronize()
    sleep_ms = start.elapsed_time(end)
    for k, fn in products.values():
        fn(torch.rand(2400, k, device=dev).bfloat16())
    waited = {name: [] for name in products}
    for i, M in enumerate(ROWS):
        for j, (name, (k, fn)) in enumerate(products.items()):
            # Each product at its own new row count.
            a = torch.rand(M + j, k, device=dev).bfloat16()
            if behind(fn, a) > 0.5 * sleep_ms:
                waited[name].append(M + j)
    print(f"  sleep {sleep_ms:.1f} ms, {len(ROWS)} new row counts each: "
          + "; ".join(f"{name} waited at {len(v)} ({v})"
                      for name, v in waited.items()), flush=True)


def main() -> int:
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
    rc = 0
    for name, env in SETTINGS.items():
        print(f"{name}:", flush=True)
        rc |= subprocess.run([sys.executable, __file__],
                             env={**os.environ, **env,
                                  "PROBE_CHILD": "1"}).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
