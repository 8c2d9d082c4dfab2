#!/usr/bin/env python3
"""K2's bf16 chain (csrc/bidi_lstm_bwd.cu, clstm_lstm_bwd_chain16 and its
L2 branch, clstm_lstm_bwd_chain in the bf16 mode) on the card, alone.

    python3 scripts/torch_k2_chain_probe.py [--k2-against SRC] [--reps N]
                                            [--phases] [--t-sweep]
                                            [--only-sweep]

Measures, at the three shapes the port runs the chain at (chip_smoke.py
CHAIN16_SHAPES: the filter's, bidi's, bidi2's H=200), in one process:

  - chip_smoke.chain16_turns: the plan of ops/bidi_lstm_kernel.py::
    chain_plan in turns with the branch it did not take (the L2 branch,
    the earlier bf16 chain, or the cluster plan), and with --k2-against
    with that source's bf16 chain;
  - every other cluster plan that fits (C of 1, 2, 4, 8; 16 or 32 rows)
    in turns with the plan, with the clusters the card holds of each;
  - the device time of each chain kernel (torch.profiler; there is no
    ncu on the machine: the probe logs whether it finds one);
  - the cluster barrier's round trip (barrier.cluster.arrive.release and
    wait.acquire, 512 threads a CTA, 32 clusters as the plans launch at
    B=256) at C = 1, 2, 3 and 4, alone and with each thread storing 6 floats
    into a peer's shared memory first (the reduce-scatter's R·H floats a
    CTA at H=200), from a kernel built here: steps × round trip is the
    chain's serial floor;
  - the registers, shared memory and spills of the chain kernels (nvcc
    -Xptxas -v; the whole report in chiprun_out/k2_chain_ptxas.txt);
  - with --t-sweep, the cluster plan in turns with the L2 branch at B=256 and T of 1 to 256 frames, every row of length T
    and ragged as a bucket of the filter's data, at H of 64 to 143 (the
    L2 branch keeps WhT in shared memory) and 160 and 200 (it does not):
    where chain_plan's CHAIN_L2_* come from; --only-sweep measures that
    alone;
  - with --phases, where a step's time goes: a copy of the source with
    clock64 marks in the chain16 kernel's loop (thread 0 of each CTA adds
    the cycles between the marks), built here, run at bidi's and bidi2's
    plans: cycles a step of phase A, the block barrier, warp 0's product,
    the second block barrier, the hand-off's copy, the next step's loads,
    the cluster barrier's arrive and its wait, the mean over the CTAs.

Prints the card, a line per measurement, and a JSON object of them all
last (also written to chiprun_out/k2_chain_probe.json). Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from clstm_tpu_torch.ops import _build  # noqa: E402
from clstm_tpu_torch.ops import bidi_lstm_kernel as bk  # noqa: E402

OUT_DIR = "chiprun_out"
# Chain steps at the bench shapes (lengths 900), for the serial floor.
STEPS = cs.TRUE_T
# The cluster barrier's loop: CTAs of 512 threads, 32 clusters (16 row
# groups of 16 rows at B=256, two directions), two slots of 4,096 floats
# (by step parity, as the chain's partials), and how many floats each
# thread stores into a peer's slot before it arrives.
BARRIER_SRC = r"""
#include <cuda_runtime.h>
namespace {
constexpr int SLOT = 4096;
__global__ void barrier_loop(int iters, int stores, float* sink) {
  extern __shared__ float buf[];
  unsigned C, rank;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(C));
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  for (int i = threadIdx.x; i < 2 * SLOT; i += blockDim.x) buf[i] = 0.0f;
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  for (int s = 0; s < iters; ++s) {
    for (int k = 0; k < stores; ++k) {
      const unsigned q = (rank + 1 + k) % C;
      const float* p = buf + (s & 1) * SLOT + (threadIdx.x * stores + k) % SLOT;
      unsigned remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(remote)
                   : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(q));
      asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote),
                   "f"((float)s) : "memory");
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
  if (threadIdx.x == 0) sink[blockIdx.x] = buf[(iters & 1) * SLOT];
}
}  // namespace
extern "C" int cluster_barrier_loop(int C, int clusters, int threads,
                                    int iters, int stores, float* sink,
                                    void* stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(C * clusters, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 2 * SLOT * sizeof(float);
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, barrier_loop, iters, stores, sink);
  return e == cudaSuccess ? (int)cudaGetLastError() : (int)e;
}
"""


# The spans between the clock64 marks --phases puts into the chain16
# kernel's loop, in their order (``instrumented``).
PHASES = ("phase A", "block barrier", "product (warp 0)", "block barrier 2",
          "hand-off copy", "next loads", "cluster arrive", "cluster wait")


def log(msg: str) -> None:
    print(msg, flush=True)


def instrumented(src: str) -> str:
    """The backward source with per-phase cycle counts in the chain16
    kernel: thread 0 of each CTA adds clock64 deltas between the marks into
    registers and writes them to g_phase[cta][8] at the end; dbg_phases
    copies them out."""
    def rep(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError(f"--phases: the source changed at {old!r}")
        return text.replace(old, new)
    mark = "    if (tid == 0) {{ tn = clock64(); pd[{0}] += tn - tq; tq = tn; }}\n"
    src = rep(src, "template <int MT, bool VEC>\n__global__",
              "__device__ unsigned long long g_phase[2 * 1024 * 8];\n"
              "template <int MT, bool VEC>\n__global__")
    src = rep(src, "  if (lmax > 0) load(lmax - 1);\n",
              "  unsigned long long pd[8] = {0, 0, 0, 0, 0, 0, 0, 0}, tq, tn;\n"
              "  if (lmax > 0) load(lmax - 1);\n")
    src = rep(src, "  for (int s = lmax - 1; s >= 0; --s) {\n    const int slot",
              "  tq = clock64();\n"
              "  for (int s = lmax - 1; s >= 0; --s) {\n    const int slot")
    src = rep(src, "    if (s == 0) break;\n    __syncthreads();\n",
              mark.format(0) + "    if (s == 0) break;\n    __syncthreads();\n"
              + mark.format(1))
    src = rep(src, "            }\n    }\n    __syncthreads();\n"
              "    // Each CTA q's slice",
              "            }\n    }\n" + mark.format(2)
              + "    __syncthreads();\n" + mark.format(3)
              + "    // Each CTA q's slice")
    src = rep(src, "    // The next step's inputs (in L2 since the prefetch two "
              "steps ago),", mark.format(4) + "    // The next step's inputs "
              "(in L2 since the prefetch two steps ago),")
    src = rep(src, "    load(s - 1);\n    cluster_arrive();\n"
              "    cluster_wait();\n",
              "    load(s - 1);\n" + mark.format(5) + "    cluster_arrive();\n"
              + mark.format(6) + "    cluster_wait();\n" + mark.format(7))
    src = rep(src, "  // No CTA leaves while a peer may still address its shared "
              "memory.\n  cluster_arrive();\n  cluster_wait();\n}\n\n"
              "// A chain16 plan",
              "  if (tid == 0)\n    for (int i = 0; i < 8; ++i)\n"
              "      g_phase[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + i] = "
              "pd[i];\n"
              "  // No CTA leaves while a peer may still address its shared "
              "memory.\n  cluster_arrive();\n  cluster_wait();\n}\n\n"
              "// A chain16 plan")
    return src + ("\nextern \"C\" int dbg_phases(unsigned long long* out) {\n"
                  "  return (int)cudaMemcpyFromSymbol(out, g_phase, "
                  "sizeof(g_phase));\n}\n")


def phase_clocks(card: str, dev) -> dict:
    """--phases: cycles a step of each span of the chain16 kernel's loop
    (PHASES) at bidi's and bidi2's plans, from the instrumented copy."""
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "bwd.cu"), os.path.join(tmp, "p.so")
        with open(_build.SRC_DIR / "bidi_lstm_bwd.cu") as f:
            text = instrumented(f.read())
        with open(cu, "w") as f:
            f.write(text)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                        "-I", str(_build.SRC_DIR), "-o",
                        so, cu], check=True, capture_output=True, timeout=900)
        lib = ctypes.CDLL(so)
    launch = bk.launcher(lib)
    out = {}
    for label, b, t, h in cs.CHAIN16_SHAPES[1:]:
        rng = np.random.RandomState(8)
        L = torch.full((b,), cs.TRUE_T, dtype=torch.int32, device=dev)
        g, c, gy, wh = cs.chain_inputs(rng, b, t, h, L, dev)
        p = bk.device_chain_plan(dev, b, t, h)
        dz = bk._chain(p, g, c, gy, wh, L, True, launch=launch)
        torch.cuda.synchronize()
        ref = bk.bidi_lstm_bwd_chain(g, c, gy, wh, L, xz_bf16=True)
        if not torch.equal(dz, ref):
            raise AssertionError("the instrumented chain differs")
        buf = (ctypes.c_ulonglong * (2 * 1024 * 8))()
        if lib.dbg_phases(buf):
            raise RuntimeError("dbg_phases failed")
        a = np.frombuffer(buf, dtype=np.uint64).reshape(-1, 8)[
            :2 * p.C * p.groups].astype(np.float64)
        per = a.mean(0) / (cs.TRUE_T - 1)
        out[label] = dict(zip(PHASES, per.tolist()))
        log(f"[phases] {card} | K2 chain bf16 {label} (plan C={p.C} rows="
            f"{p.rows}): cycles a step, the mean over the CTAs: " + ", ".join(
                f"{k} {v:.0f}" for k, v in out[label].items())
            + f" (sum {per.sum():.0f})")
    return out


def ptxas() -> dict:
    """nvcc -Xptxas -v over the backward source: {kernel: its report line}
    for the chain kernels; the whole report to OUT_DIR."""
    src = str(_build.SRC_DIR / "bidi_lstm_bwd.cu")
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                            "-v", "-c", "-o", os.path.join(tmp, "bwd.o"),
                            src], capture_output=True, text=True, timeout=900)
    text = r.stdout + r.stderr
    with open(os.path.join(OUT_DIR, "k2_chain_ptxas.txt"), "w") as f:
        f.write(text)
    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and "chain" in name and "Used" in line:
            out[name[-60:]] = line.split("ptxas info    :")[-1].strip()
        elif name and "chain" in name and "spill" in line:
            out[name[-60:] + " spills"] = line.strip()
    return out


def barrier_floor(card: str, reps: int) -> dict:
    """The cluster barrier's round trip (µs) at C of 1 to 4, alone and
    with 6 stores a thread into a peer first: the time of a launch of 2,000
    steps less one of 200, over 1,800, the mean of ``reps`` launches."""
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "barrier.cu"), os.path.join(tmp, "b.so")
        with open(cu, "w") as f:
            f.write(BARRIER_SRC)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        so, cu], check=True, capture_output=True,
                       timeout=600)
        lib = ctypes.CDLL(so)
    fn = lib.cluster_barrier_loop
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    sink = torch.zeros(4 * 32, device="cuda")
    out = {}
    for C in (1, 2, 3, 4):
        for stores in (0, 6):
            def run(iters):
                err = fn(C, 32, bk.CHAIN_THREADS, iters, stores,
                         sink.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"barrier loop: CUDA error {err}")
            lo, hi = (cs.time_ms(lambda n=n: run(n), reps) for n in (200,
                                                                      2000))
            us = (hi - lo) * 1e3 / 1800
            key = f"C={C} stores={stores}"
            out[key] = {"round_trip_us": us,
                        "serial_floor_ms_900_steps": us * STEPS / 1e3}
            log(f"[barrier] {card} | cluster barrier round trip, {key}: "
                f"{us:.4f} µs (launch of 200 steps {lo:.4f} ms, of 2,000 "
                f"{hi:.4f} ms); x {STEPS} steps = "
                f"{us * STEPS / 1e3:.4f} ms")
    return out


def plan_alternatives(card: str, dev, reps: int) -> dict:
    """At bidi's and bidi2's shapes, every cluster plan that fits (C,
    rows) in turns with the plan (plan, other, other, plan)."""
    out = {}
    for label, b, t, h in cs.CHAIN16_SHAPES[1:]:
        rng = np.random.RandomState(8)
        L = torch.full((b,), cs.TRUE_T, dtype=torch.int32, device=dev)
        g, c, gy, wh = cs.chain_inputs(rng, b, t, h, L, dev)
        plan = bk.device_chain_plan(dev, b, t, h)

        def cur():
            return bk.bidi_lstm_bwd_chain(g, c, gy, wh, L, xz_bf16=True)
        ref = cur().float()
        rows = {}
        for C in bk.CHAIN_CLUSTER_SIZES:
            for r in bk.CHAIN_ROWS:
                units = bk.chain_units(h, C)
                if not units or not bk.chain_smem(
                        h, C, r, units, bk.chain_ksplit(h, C, r, units)):
                    continue
                p = bk.chain_cluster_plan(b, h, bk.chain_clusters(dev, h),
                                          C=C, rows=r)

                def alt(p=p):
                    return bk._chain(p, g, c, gy, wh, L, True)
                e = cs.rel_err(alt().float(), ref)
                if not e <= 2e-2:
                    raise AssertionError(f"plan {p}: {e:.3e} off")
                k_t, a_t = cs.in_turns(cur, alt, reps)
                key = f"C={C} rows={r}"
                rows[key] = {"plan": p._asdict(), "ms": a_t, "plan_ms": k_t}
                log(f"[plans] {card} | K2 chain bf16 {label}: {key} "
                    f"(ksplit {p.ksplit}, {p.clusters} clusters at once, "
                    f"{-(-2 * p.groups // p.clusters)} waves) in turns with "
                    f"the plan (C={plan.C} rows={plan.rows}): plan "
                    f"{k_t[0]:.4f}, it {a_t[0]:.4f}, {a_t[1]:.4f}, plan "
                    f"{k_t[1]:.4f} ms")
        out[label] = {"plan": plan._asdict(), "alternatives": rows}
        del g, c, gy, wh
    return out


def device_times(dev, reps: int) -> dict:
    """torch.profiler's device ms per launch of each kernel the chain runs,
    the plan's and the branch it did not take, at the three shapes."""
    out = {}
    for label, b, t, h in cs.CHAIN16_SHAPES:
        rng = np.random.RandomState(8)
        L = (torch.full((b,), cs.TRUE_T, dtype=torch.int32, device=dev)
             if t == cs.T else torch.from_numpy(
                 rng.randint(11, t + 1, b).astype(np.int32)).to(dev))
        g, c, gy, wh = cs.chain_inputs(rng, b, t, h, L, dev)
        for key, p in (("plan", bk.device_chain_plan(dev, b, t, h)),
                       ("other branch", cs.chain_other(dev, b, t, h))):
            def fn():
                return bk._chain(p, g, c, gy, wh, L, True)
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            out[f"{label} {key}"] = {
                cs.kernel_name(e.key): cs.device_us(e) / reps / 1e3
                for e in prof.key_averages() if cs.device_us(e) > 0}
            log(f"[device] {label} {key}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in out[f"{label} {key}"].items()))
        del g, c, gy, wh
    return out


# --t-sweep: widths and chain lengths at B=256.
SWEEP_H = (64, 80, 100, 120, 143, 160, 200)
SWEEP_T = (1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 256)


def sweep_lengths(rng, b: int, t: int, mode: str) -> np.ndarray:
    """Row lengths of the sweep: "full", every row T frames; "ragged", as
    a bucket of the filter's data holds them (chip_smoke's filter shape:
    11-32 frames at T=32), uniform in [ceil(T/3), T] with the first row T."""
    if mode == "full":
        return np.full(b, t, dtype=np.int32)
    ln = rng.randint(-(-t // 3), t + 1, b).astype(np.int32)
    ln[0] = t
    return ln


def t_sweep(card: str, dev, reps: int) -> dict:
    """The cluster plan (chain_cluster_plan) in turns with the L2 branch (cluster, L2, L2, cluster) at B=256, for H in
    SWEEP_H and T in SWEEP_T, with full and ragged lengths
    (sweep_lengths); both through the launch the wrapper makes
    (bk._chain), so the host's share is in."""
    out = {}
    b = cs.B
    for mode in ("full", "ragged"):
        for h in SWEEP_H:
            p = bk.chain_cluster_plan(b, h, bk.chain_clusters(dev, h))
            row = {"plan": p._asdict(), "l2_resident": h <= 143}
            for t in SWEEP_T:
                rng = np.random.RandomState(8)
                L = torch.from_numpy(sweep_lengths(rng, b, t, mode)).to(dev)
                g, c, gy, wh = cs.chain_inputs(rng, b, t, h, L, dev)

                def clu():
                    return bk._chain(p, g, c, gy, wh, L, True)

                def l2():
                    return bk._chain(bk.CHAIN_L2, g, c, gy, wh, L, True)
                e = cs.rel_err(l2().float(), clu().float())
                if not e <= 2e-2:
                    raise AssertionError(f"sweep H={h} T={t}: {e:.3e} off")
                k_t, l_t = cs.in_turns(clu, l2, reps)
                row[t] = {"cluster_ms": k_t, "l2_ms": l_t}
                log(f"[sweep] {card} | K2 chain bf16 B={b} H={h} T={t} "
                    f"{mode} (WhT "
                    f"{'resident' if row['l2_resident'] else 'in L2'} in "
                    f"the L2 branch): in turns cluster C={p.C} "
                    f"{k_t[0]:.4f}, L2 {l_t[0]:.4f}, {l_t[1]:.4f}, "
                    f"cluster {k_t[1]:.4f} ms")
                del g, c, gy, wh
            out[f"{mode} H={h}"] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k2-against", metavar="SRC",
                    help="also time this K2 source's bf16 chain in turns")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--phases", action="store_true",
                    help="also the cycles a step of each phase of the loop")
    ap.add_argument("--t-sweep", action="store_true",
                    help="also the cluster plan against the L2 branch over "
                    "chain lengths")
    ap.add_argument("--only-sweep", action="store_true",
                    help="measure the --t-sweep alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k2_chain_probe: needs a CUDA card")
    t0 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = cs.torch_device("cuda")
    card = cs.card_line()
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(f"[device] ncu: {shutil.which('ncu') or 'not on this machine'}")
    _build.build()
    _build.load_library()
    res = {"card": card}
    if not args.only_sweep:
        res["ptxas"] = ptxas()
        for k, v in res["ptxas"].items():
            log(f"[ptxas] {k}: {v}")
        k2_against = (cs.load_against(args.k2_against)
                      if args.k2_against else None)
        res["turns"] = cs.chain16_turns(dev, card, k2_against, args.reps)
        res["plans"] = plan_alternatives(card, dev, args.reps)
        res["device_ms"] = device_times(dev, args.reps)
        res["barrier"] = barrier_floor(card, args.reps)
        if args.phases:
            res["phases"] = phase_clocks(card, dev)
    if args.t_sweep or args.only_sweep:
        res["t_sweep"] = t_sweep(card, dev, args.reps)
    res["seconds"] = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "k2_chain_probe.json"), "w") as f:
        json.dump(res, f, indent=1)
    log(f"[done] in {res['seconds']:.1f} s")
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
