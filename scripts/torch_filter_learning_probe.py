#!/usr/bin/env python3
"""How fast clstmfiltertrain learns the g2p task at full width, per
learning rate: the numbers chip_smoke.py's filter phase takes its ntrain
and lrate from.

    python3 scripts/torch_filter_learning_probe.py [--lrates 1e-4,3e-5]
        [--ntrain 262144] [--test-every 16384] [--device cuda]

Builds chip_smoke.py's corpus (the run-cmu g2p task of bench.py:269-345:
4,096 training pairs and 512 held-out words) and runs the port's
clstmfiltertrain main on it once per learning rate, as chip_smoke.py
does: bidi, nhidden 100, input_repeat 3, B=256, automatic K. Prints the
card, then per rate the TESTERR curve, the seconds the run took and the
trials at which TESTERR first fell below half its first value.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from clstm_tpu_torch.cli import clstmfiltertrain  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lrates", default="1e-4,3e-5")
    ap.add_argument("--ntrain", type=int, default=262144)
    ap.add_argument("--test-every", type=int, default=16384)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    train_pairs, test_pairs = cs.g2p_corpus()
    with tempfile.TemporaryDirectory() as tmp:
        files = [cs.write_tsv(os.path.join(tmp, "train.tsv"), train_pairs),
                 cs.write_tsv(os.path.join(tmp, "test.tsv"), test_pairs)]
        for lr in args.lrates.split(","):
            env = dict(cs.FILTER_ENV, device=args.device, lrate=lr,
                       ntrain=str(args.ntrain),
                       test_every=str(args.test_every),
                       save_every=str(args.test_every),
                       report_every=str(args.test_every),
                       save_name=os.path.join(tmp, f"f{lr}"))
            os.environ.update(env)
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                clstmfiltertrain.main(files)
            secs = time.perf_counter() - t0
            curve = [(int(ln.split()[1]), float(ln.split()[2]))
                     for ln in out.getvalue().splitlines()
                     if ln.startswith("TESTERR ")]
            halved = next((t for t, e in curve[1:]
                           if e < 0.5 * curve[0][1]), None)
            print(f"lrate {lr}: TESTERR " + ", ".join(
                f"{t}: {e:.4f}" for t, e in curve)
                + f"; {secs:.1f} s; below half the first at {halved}",
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
