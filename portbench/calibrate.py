"""The readings the limits of ``correct`` are set from, for one cell over
many seeds in one process: the program's numbers (lower readings), the
control's (the reference in the program's place at a lower precision:
float8 e4m3 operands for the configuration's bf16), and each fault the cell
can have (upper readings):

"half", half of each batch left out, the mean taken over the rest (planted
in the reference put in the program's place); a state returned unchanged
reads 1 on change_gap by its measure and needs no run.

  python3 portbench/calibrate.py --workload <cell> --seeds 12

One JSON line a seed on standard output, and the same in
portbench/out/calibrate_<cell>.jsonl.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness, registry  # noqa: E402


def train_readings(run, drv) -> dict:
    from portbench.reference import train as ref_train
    st = drv.setup(run)
    batches = drv.check_batches(run, st)
    lr, mom = run.mix["lrate"], run.mix["momentum"]
    ref = ref_train.steps(st["weights"], batches, lr, mom)
    out = {"program": ref_train.numbers(st["check"], ref)}
    for name, kw in (("control", {"rounding": "fp8"}),
                     ("half", {"fault": "half"})):
        out[name] = ref_train.numbers(
            ref_train.steps(st["weights"], batches, lr, mom, **kw), ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    harness.set_caches()
    man = registry.manifest()
    os.makedirs(os.path.join(registry.HERE, "out"), exist_ok=True)
    path = os.path.join(registry.HERE, "out", f"calibrate_{a.workload}.jsonl")
    with open(path, "a", encoding="utf-8") as f:
        for k in range(a.seeds):
            seed = a.first_seed + 7919 * k
            args = argparse.Namespace(workload=a.workload, seed=seed,
                                      seconds=0.0, trace=0)
            run = harness.Run(man, a.workload, args, "cuda")
            drv = registry.driver(run.mix["driver"])
            t0 = time.time()
            rd = train_readings(run, drv)
            rd.update(seed=seed, seconds=time.time() - t0,
                      card=torch.cuda.get_device_name(0))
            line = json.dumps(rd)
            print(line, flush=True)
            f.write(line + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
