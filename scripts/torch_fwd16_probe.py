#!/usr/bin/env python3
"""The bf16 mode's forward on the tensor cores (csrc/bidi_lstm_fwd.cu,
fwd16_kernel): K1 and K4's state mode (clstm_bidi_lstm_fwd16_state and
_xz_state, training) and K3 and K4 inference (clstm_bidi_lstm_fwd16 and
_xz, serving) on the card, alone.

    python3 scripts/torch_fwd16_probe.py [--mode state|infer|both]
                                         [--fwd-against SRC] [--reps N]
                                         [--phases] [--t-sweep]
                                         [--only-sweep]

Measures, in one process, for the modes ``--mode`` names (both by
default):

  - chip_smoke.fwd16_turns: at the five shapes the port runs each mode at
    (chip_smoke.py FWD16_SHAPES: bidi's K1, bidi2's K1 at layer 1 and K4
    state at layer 2, the filter's K1 at T=16 and 32; FWD16_INFER_SHAPES:
    the same shapes for K3 and K4 inference), the fwd16 kernel in turns
    with the FMA kernel's bf16 instance forced at its own plan (fwd_plan),
    with cuDNN's bf16 nn.LSTM, and with --fwd-against with that source's
    bf16 kernel of the mode;
  - every other fwd16 plan that fits (C of 1, 2, 3, 4, 8; 16 or 32 rows) in
    turns with the plan at bidi and bidi2's two layers, with the clusters
    the card holds of each;
  - the device time of each kernel (torch.profiler);
  - the registers, shared memory and spills of the fwd16 kernels (nvcc
    -Xptxas -v; the whole report in chiprun_out/fwd16_ptxas.txt);
  - with --phases, where a step's time goes: the source built with
    CLSTM_FWD16_PHASES (thread 0 of each CTA adds clock64 deltas between
    marks in the kernel's loop), run at the three bench plans: cycles a step
    of the cluster barrier's wait, the x (K1, K3) or xz (K4) staging, the
    product, the gate math with its writes to the output stage, the block
    barrier, the hand-off's copy, the arrive, the next step's input and the
    stores from the stage, the mean over the CTAs;
  - with --t-sweep, the fwd16 cluster plan in turns with the FMA kernel
    over T of 1 to 256 frames, every row of length T and ragged as a
    bucket of the filter's data, for K1 and K3 (D=20, the filter's padded
    input) and K4 in the mode: the state modes at B=256 and H of 64 to 200
    (where fwd16_plan's FWD16_OLD_* come from), inference at B=256 and at
    B=64 (a clstmocr page-set bucket) and H of 100 and 200 (which put its
    crossovers at the same FWD16_OLD_*); --only-sweep measures that
    alone.

Prints the card, a line per measurement, and a JSON object of them all
last (also written to chiprun_out/fwd16_probe.json). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
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
from clstm_tpu_torch.ops import lstm as lstm_ops  # noqa: E402

OUT_DIR = "chiprun_out"
# The spans the CLSTM_FWD16_PHASES build counts (csrc F16_MARK), in order.
PHASES = ("cluster wait", "x/xz staging", "product", "gate math and stage",
          "block barrier", "hand-off copy", "cluster arrive", "next input",
          "stores")
# The bench shapes per mode (state: True, inference: False; label, D, H; D
# 0: K4 at bidi2's layer 2).
BENCH = {True: (("bidi K1", cs.D, cs.H), ("bidi2 layer 1 K1", cs.D, cs.H2),
                ("bidi2 layer 2 K4 state", 0, cs.H2)),
         False: (("bidi K3", cs.D, cs.H), ("bidi2 layer 1 K3", cs.D, cs.H2),
                 ("bidi2 layer 2 K4", 0, cs.H2))}


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_inputs(dev, d: int, h: int, t: int = cs.T, lengths=None,
                 state: bool = True, b: int = cs.B):
    """Seeded weights and the kernel's input at B=b (256): x [b, t, d] for
    K1 (K3 without ``state``), the bf16 hoisted product of x [b, t, 400]
    for d 0 -> (pf, pr, inp, hoist, lengths, kind, the kernel's D)."""
    rng = np.random.RandomState(9)
    hoist = d == 0
    dx = cs.D2 if hoist else d
    sc = 0.3 if h == cs.H else 0.1
    pf, pr = cs.lstm_params(rng, dx, h, dev, sc), cs.lstm_params(rng, dx, h,
                                                                 dev, sc)
    x = cs.uniform(rng, (b, t, dx), -1.0, 1.0, dev)
    inp = (lstm_ops.hoisted_projection(pf, pr, x, xz_bf16=True) if hoist
           else x)
    L = (lengths if lengths is not None else
         torch.full((b,), min(t, cs.TRUE_T), dtype=torch.int32,
                    device=dev))
    kind = ("fwd_xz" if hoist else "fwd") + ("_state" if state else "")
    return pf, pr, inp, hoist, L, kind, 0 if hoist else d + d % 2


def fwd(kind: str, plan, pf, pr, inp, L):
    """bk._fwd in the bf16 mode, its outputs as a tuple in either mode."""
    out = bk._fwd(kind, plan, pf, pr, inp, L, True)
    return out if isinstance(out, tuple) else (out,)


def phase_clocks(card: str, dev, modes) -> dict:
    """--phases: cycles a step of each span (PHASES) of the fwd16 kernel's
    loop at the three bench plans of each mode in ``modes`` (state: True),
    from the CLSTM_FWD16_PHASES build."""
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "p.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        "-DCLSTM_FWD16_PHASES", "-shared", "-o", so,
                        str(_build.SRC_DIR / "bidi_lstm_fwd.cu")],
                       check=True, capture_output=True, timeout=900)
        lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.clstm_bidi_lstm_fwd16_state.argtypes = [P] * 7 + [I] * 7 + [P]
    lib.clstm_bidi_lstm_fwd16_xz_state.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.clstm_bidi_lstm_fwd16.argtypes = [P] * 5 + [I] * 7 + [P]
    lib.clstm_bidi_lstm_fwd16_xz.argtypes = [P] * 4 + [I] * 6 + [P]
    lib.clstm_fwd16_phases.argtypes = [P, I]
    out = {}
    for state in modes:
        for label, d, h in BENCH[state]:
            out[label] = phase_clocks_at(card, dev, lib, label, d, h, state)
    return out


def phase_clocks_at(card: str, dev, lib, label: str, d: int, h: int,
                    state: bool) -> dict:
    """phase_clocks at one bench shape and mode."""
    pf, pr, inp, hoist, L, kind, dk = bench_inputs(dev, d, h, state=state)
    p = bk.device_fwd16_plan(dev, cs.B, cs.T, dk, h, hoist, state=state)
    if not hoist:
        inp = bk._x_bf16(inp)
    wx, wh = bk.fwd16_weights(pf, pr, not hoist)
    y = torch.empty((cs.B, cs.T, 2 * h), dtype=torch.bfloat16, device=dev)
    outs = [y]
    if state:
        outs += [torch.empty((cs.B, cs.T, 2, 4 * h), device=dev),
                 torch.empty((cs.B, cs.T, 2, h), dtype=torch.bfloat16,
                             device=dev)]
    name = ("clstm_bidi_lstm_fwd16" + ("_xz" if hoist else "")
            + ("_state" if state else ""))
    ptrs = [inp.data_ptr(), L.data_ptr()] + ([] if hoist else [
        wx.data_ptr()]) + [wh.data_ptr()] + [o.data_ptr() for o in outs]
    ints = [cs.B, cs.T] + ([] if hoist else [dk]) + [h, p.C, p.rows, p.units]
    err = getattr(lib, name)(*ptrs, *ints,
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"instrumented fwd16: CUDA error {err}")
    torch.cuda.synchronize()
    ref = fwd(kind, p, pf, pr, inp, L)
    if not all(map(torch.equal, outs, ref)):
        raise AssertionError("the instrumented fwd16 kernel differs")
    n = 2 * p.C * p.groups * len(PHASES)
    buf = (ctypes.c_ulonglong * n)()
    if lib.clstm_fwd16_phases(buf, n):
        raise RuntimeError("clstm_fwd16_phases failed")
    a = np.frombuffer(buf, dtype=np.uint64).reshape(
        2, -1, len(PHASES))[:, :p.C * p.groups].astype(np.float64)
    per = a.reshape(-1, len(PHASES)).mean(0) / cs.TRUE_T
    out = dict(zip(PHASES, per.tolist()))
    log(f"[phases] {card} | fwd16 {label} (plan C={p.C} rows={p.rows} "
        f"units={p.units}): cycles a step, thread 0, the mean over the "
        "CTAs: " + ", ".join(f"{k} {v:.0f}" for k, v in out.items())
        + f" (sum {per.sum():.0f})")
    return out


def ptxas() -> dict:
    """nvcc -Xptxas -v over the forward source: {kernel: its report} for
    the fwd16 kernels; the whole report to OUT_DIR."""
    src = str(_build.SRC_DIR / "bidi_lstm_fwd.cu")
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                            "-v", "-c", "-o", os.path.join(tmp, "fwd.o"),
                            src], capture_output=True, text=True, timeout=900)
    text = r.stdout + r.stderr
    with open(os.path.join(OUT_DIR, "fwd16_ptxas.txt"), "w") as f:
        f.write(text)
    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            name = line.split("'")[1] if "'" in line else line.split()[-1]
        elif name and "fwd16" in name and ("Used" in line or "spill" in line):
            key = name[name.index("fwd16"):][:40]
            out[key] = (out.get(key, "") + " " + line.strip()).strip()
    return out


def plan_alternatives(card: str, dev, reps: int, state: bool) -> dict:
    """At the three bench shapes of the mode, every fwd16 plan that fits
    (C, rows) in turns with the plan (plan, other, other, plan)."""
    out = {}
    for label, d, h in BENCH[state]:
        pf, pr, inp, hoist, L, kind, dk = bench_inputs(dev, d, h,
                                                       state=state)
        plan = bk.device_fwd16_plan(dev, cs.B, cs.T, dk, h, hoist,
                                    state=state)

        def cur():
            return fwd(kind, plan, pf, pr, inp, L)
        ref = cur()
        rows = {}
        for C in bk.FWD16_CLUSTER_SIZES:
            for r in bk.FWD16_ROWS:
                p = bk.fwd16_cluster_plan(
                    cs.B, dk, h, hoist,
                    bk.fwd16_clusters(dev, dk, h, hoist, state=state), C=C,
                    rows=r, state=state)
                if not p.C or p == plan:
                    continue

                def alt(p=p):
                    return fwd(kind, p, pf, pr, inp, L)
                if not all(map(torch.equal, alt(), ref)):
                    raise AssertionError(f"plan {p} differs from {plan}")
                k_t, a_t = cs.in_turns(cur, alt, reps)
                key = f"C={C} rows={r}"
                rows[key] = {"plan": p._asdict(), "ms": a_t, "plan_ms": k_t}
                log(f"[plans] {card} | fwd16 {label}: {key} (units "
                    f"{p.units}, {p.smem} bytes, {p.clusters} clusters at "
                    f"once, {-(-2 * p.groups // p.clusters)} waves) in turns "
                    f"with the plan (C={plan.C} rows={plan.rows}): plan "
                    f"{k_t[0]:.4f}, it {a_t[0]:.4f}, {a_t[1]:.4f}, plan "
                    f"{k_t[1]:.4f} ms; bitwise equal")
        out[label] = {"plan": plan._asdict(), "alternatives": rows}
    return out


def device_times(dev, reps: int, state: bool) -> dict:
    """torch.profiler's device ms per launch of the fwd16 kernel and of the
    FMA kernel at the three bench shapes of the mode."""
    out = {}
    for label, d, h in BENCH[state]:
        pf, pr, inp, hoist, L, kind, dk = bench_inputs(dev, d, h,
                                                       state=state)
        for key, p in (("fwd16", bk.device_fwd16_plan(
                dev, cs.B, cs.T, dk, h, hoist, state=state)),
                       ("the FMA kernel", bk.device_plan(
                           dev, cs.B, dk, h, hoist, state, 2))):
            def fn():
                return fwd(kind, p, pf, pr, inp, L)
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
    return out


# --t-sweep: widths, batches and chain lengths per mode (state: True).
SWEEP_H = {True: (64, 100, 200), False: (100, 200)}
SWEEP_B = {True: (cs.B,), False: (cs.B, 64)}
SWEEP_T = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def t_sweep(card: str, dev, reps: int, state: bool) -> dict:
    """The fwd16 cluster plan in turns with the FMA kernel (fwd16, FMA,
    FMA, fwd16) for K1 or K3 (D=20) and K4 in the mode, B in SWEEP_B, H in
    SWEEP_H, T in SWEEP_T, with full and ragged lengths (as
    chip_smoke.fwd16_lengths: uniform in [ceil(T/3), T]); both through
    bk._fwd, the launch the wrapper makes."""
    out = {}
    for d in (20, 0):
        for b in SWEEP_B[state]:
            for mode in ("full", "ragged"):
                for h in SWEEP_H[state]:
                    row = {}
                    for t in SWEEP_T:
                        rng = np.random.RandomState(8)
                        L = (torch.full((b,), t, dtype=torch.int32,
                                        device=dev) if mode == "full"
                             else cs.fwd16_lengths(rng, b, t, dev))
                        pf, pr, inp, hoist, L, kind, dk = bench_inputs(
                            dev, d, h, t, L, state, b)
                        p = bk.fwd16_cluster_plan(
                            b, dk, h, hoist,
                            bk.fwd16_clusters(dev, dk, h, hoist, state=state),
                            state=state)
                        old = bk.device_plan(dev, b, dk, h, hoist, state, 2)

                        def new():
                            return fwd(kind, p, pf, pr, inp, L)

                        def fma():
                            return fwd(kind, old, pf, pr, inp, L)
                        e = max(cs.rel_err(u.float(), v.float())
                                for u, v in zip(new(), fma()))
                        if not e <= 2e-2:
                            raise AssertionError(f"sweep {kind} H={h} T={t}: "
                                                 f"{e:.3e} off")
                        k_t, o_t = cs.in_turns(new, fma, reps)
                        row[t] = {"fwd16_ms": k_t, "fma_ms": o_t}
                        log(f"[sweep] {card} | {kind} B={b} D={d or '-'} "
                            f"H={h} T={t} {mode}: in turns fwd16 C={p.C} "
                            f"{k_t[0]:.4f}, FMA C={old.C} {o_t[0]:.4f}, "
                            f"{o_t[1]:.4f}, fwd16 {k_t[1]:.4f} ms; ratio "
                            f"{sum(o_t) / sum(k_t):.2f}")
                        del pf, pr, inp
                    name = ("K4" if d == 0 else "K1" if state else "K3") + (
                        " state" if state and d == 0 else "")
                    key = f"{name} {mode} H={h}"
                    out[key if b == cs.B else f"{key} B={b}"] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("state", "infer", "both"),
                    default="both",
                    help="K1 and K4's state mode (training), K3 and K4 "
                    "inference (serving), or both")
    ap.add_argument("--fwd-against", metavar="SRC",
                    help="also time this forward source's bf16 kernels of "
                    "the modes in turns (chip_smoke.py --fwd-against)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--phases", action="store_true",
                    help="also the cycles a step of each span of the loop")
    ap.add_argument("--t-sweep", action="store_true",
                    help="also the fwd16 plan against the FMA kernel over "
                    "chain lengths")
    ap.add_argument("--only-sweep", action="store_true",
                    help="measure the --t-sweep alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fwd16_probe: needs a CUDA card")
    modes = {"state": (True,), "infer": (False,),
             "both": (True, False)}[args.mode]
    t0 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = cs.torch_device("cuda")
    card = cs.card_line()
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    _build.build()
    _build.load_library()
    res = {"card": card}
    if not args.only_sweep:
        res["ptxas"] = ptxas()
        for k, v in res["ptxas"].items():
            log(f"[ptxas] {k}: {v}")
        fwd_against = (cs.load_fwd_against(args.fwd_against)
                       if args.fwd_against else None)
        with torch.no_grad():
            for state in modes:
                tag = "state" if state else "infer"
                res[f"turns {tag}"] = cs.fwd16_turns(dev, card, fwd_against,
                                                     args.reps, state)
                res[f"plans {tag}"] = plan_alternatives(card, dev, args.reps,
                                                        state)
                res[f"device_ms {tag}"] = device_times(dev, args.reps, state)
            if args.phases:
                res["phases"] = phase_clocks(card, dev, modes)
    if args.t_sweep or args.only_sweep:
        with torch.no_grad():
            for state in modes:
                res[f"t_sweep {'state' if state else 'infer'}"] = t_sweep(
                    card, dev, args.reps, state)
    res["seconds"] = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "fwd16_probe.json"), "w") as f:
        json.dump(res, f, indent=1)
    log(f"[done] in {res['seconds']:.1f} s")
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
