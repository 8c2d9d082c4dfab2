"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), the check against the reference, and the result line.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

The run needs the cards its cell asks for and fails without them: it never
runs on the CPU in their place. Its last line on standard output is one
JSON object, {"correct", "attempted", "failed", "metrics", "device",
["breakdown"], "checks"}; the numbers that decided ``correct``, each beside
its limit, are also the last lines on standard error. Set-up is counted
from the start of the process to the first timed call.

The kernels' library is built into, and loaded from, portbench/.cache/
kernels inside the checkout, so only a checkout's first run builds it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

from portbench import registry

# The top-level modules a run may not hold once its window has closed: JAX
# and the package the port was made from (names compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "clstm_tpu")
CACHE = os.path.join(registry.HERE, ".cache")


def process_start() -> float:
    """time.time() at this process's start (Linux: /proc), else now."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime", encoding="ascii") as f:
            up = float(f.read().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
        return time.time() - up + int(fields[19]) / hz
    except (OSError, ValueError, IndexError):
        return time.time()


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_caches() -> str:
    """Point every build and kernel cache of the program into the
    checkout, at fixed paths."""
    from clstm_tpu_torch.utils.config import enable_compile_cache
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    return enable_compile_cache(os.path.join(CACHE, "kernels"))


class Run:
    """What a driver is handed: the cell, its configuration, its mix, the
    arguments and the device."""

    def __init__(self, man: dict, workload: str, args, device: str,
                 base: str = registry.HERE, root: str = registry.ROOT,
                 overrides: dict = None):
        self.cell = registry.cell(man, workload)
        self.cfg = registry.config(man, self.cell["config"], root)
        self.mix = registry.traffic(self.cell["traffic"], base)
        for key, val in (overrides or {}).items():
            getattr(self, key).update(val)
        self.args = args
        self.seed = args.seed
        self.device = device
        self.workload = workload


def device_info(device: str, chips: int) -> dict:
    import torch
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(
                torch.cuda.max_memory_allocated(i) for i in range(chips)))}


def per_layer(run: Run, per: list, ctx: dict, base: str) -> dict:
    """Each per-layer metric's reader over ``ctx``; a reader that finds
    nothing returns None and the metric is left out."""
    out = {}
    for m in per:
        v = registry.metric_reader(m["name"], base)(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every number at most its limit (a NaN fails)."""
    checks = {}
    for name, lim in limits.items():
        v = numbers.get(name)
        checks[name] = {"value": v, "limit": lim}
    ok = all(isinstance(c["value"], (int, float))
             and not math.isnan(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def run_cell(run: Run, trace: bool, t_start: float,
             base: str = registry.HERE, man: dict = None) -> dict:
    """Set-up, window, traced window, check -> the result object."""
    import torch
    man = man or registry.manifest()
    drv = registry.driver(run.mix["driver"], base)
    e2e, per = registry.cell_metrics(man, run.workload)
    cuda = run.device == "cuda"
    t_setup = time.time()
    state = drv.setup(run)
    state["import_s"] = t_setup - t_start
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    win = drv.window(run, state, run.args.seconds)
    result = {"correct": False, "attempted": win["attempted"],
              "failed": win["failed"]}
    if trace:
        ctx = {"run": run, "window": win, "kernels": registry.kernels(base)}
        ctx.update(drv.traced(run, state))
        metrics = per_layer(run, per, ctx, base)
    else:
        values = dict(win["end_to_end"], setup_s=setup_s)
        metrics = {}
        for m in e2e:
            if m["name"] not in values:
                raise KeyError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info(run.device, run.cell["chips"])
    if trace:
        from portbench.trace import breakdown
        result["device"]["busy_s"] = ctx["trace"]["busy_us"] * 1e-6
        result["device"]["window_s"] = ctx["trace"]["window_us"] * 1e-6
        result["breakdown"] = breakdown(ctx["trace"])
    result["notes"] = dict(win.get("notes", {}),
                           import_s=state.get("import_s"))
    if trace:
        result["notes"]["launches"] = ctx.get("launches")
        result["notes"]["traced_steps"] = len(ctx["steps"])
    t = time.time()
    numbers = drv.judge(run, state)
    result["notes"]["check_s"] = time.time() - t
    del state
    ok, checks = judge(numbers, registry.limits(run.workload, base))
    result["correct"] = ok
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    t_start = process_start()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    man = registry.manifest()
    cell = registry.cell(man, args.workload)
    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell {args.workload} needs {cell['chips']} "
              f"CUDA card(s); this machine has {have}", file=sys.stderr)
        return 2
    set_caches()
    run = Run(man, args.workload, args, "cuda")
    result = run_cell(run, bool(args.trace), t_start, man=man)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["checks"] = checks           # the last key of the line
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
