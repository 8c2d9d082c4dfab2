"""Runs of the benchmark's cells at a size a CPU test holds: the same
harness, drivers, reference and limits, at the tiny size the cell's family
gives (its ``tiny``), in f32."""

import argparse
import time

from portbench import harness, registry

MAN = registry.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def tiny_run(workload: str, seed: int = 2 ** 31 + 99, man: dict = None,
             base: str = registry.HERE, root: str = registry.ROOT):
    """A Run of ``workload`` on the CPU at its family's tiny size."""
    man = man or MAN
    cfg = registry.config(man, registry.cell(man, workload)["config"], root)
    ov = registry.family(cfg, root).tiny(cfg)
    args = argparse.Namespace(workload=workload, seed=seed, seconds=0.5,
                              trace=0)
    return harness.Run(man, workload, args, "cpu", base=base, root=root,
                       overrides=ov), man


def run_tiny(workload: str, seed: int = 2 ** 31 + 99, man: dict = None,
             base: str = registry.HERE, root: str = registry.ROOT) -> dict:
    """One run of ``workload`` at the tiny size on the CPU -> its result
    (the look for a card skipped)."""
    run, man = tiny_run(workload, seed, man, base, root)
    return harness.run_cell(run, False, time.time(), base=base, man=man)
