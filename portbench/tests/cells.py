"""Runs of the benchmark's cells at a size a CPU test holds: the same
harness, drivers, reference and limits, on tiny widths in f32."""

import argparse
import time

from portbench import harness, registry

MAN = registry.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]

TINY = {
    "train": {"cfg": {"nhidden_layers": [8], "noutput": 12,
                      "precision": "f32"},
              "mix": {"lines": 48, "width_min": 40, "width_max": 120,
                      "cell_cols": 11, "glyph_cols": [6, 9],
                      "batch_size": 8, "steps_per_dispatch": 3}},
}


def tiny_run(workload: str, seed: int = 2 ** 31 + 99):
    man = MAN
    kind = registry.traffic(registry.cell(man, workload)["traffic"])[
        "driver"]
    ov = {k: dict(v) for k, v in TINY[kind].items()}
    depth = len(registry.config(man, registry.cell(man, workload)[
        "config"])["nhidden_layers"])
    ov["cfg"]["nhidden_layers"] = [8] * depth
    args = argparse.Namespace(workload=workload, seed=seed, seconds=0.5,
                              trace=0)
    return harness.Run(man, workload, args, "cpu", overrides=ov), man


def run_tiny(workload: str, seed: int = 2 ** 31 + 99) -> dict:
    """One run of ``workload`` at the tiny size on the CPU -> its result
    (the look for a card skipped)."""
    run, man = tiny_run(workload, seed)
    return harness.run_cell(run, False, time.time(), man=man)
