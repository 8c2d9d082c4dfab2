"""The comparison that decides ``correct`` fails its control: the
reference put in the program's place at a lower precision (float8 e4m3
operands, the step below the configurations' bf16), and each fault a cell
can have.

The card test runs them at each cell's own size on three seeds
(portbench/calibrate.py's readings) against the cell's limits; the CPU
test holds the same comparison at a tiny size, where the program's f32
path reads at rounding."""

import pytest

from portbench import calibrate, harness, registry
from portbench.tests.cells import MAN, tiny_run

CELLS = [w["name"] for w in MAN["workloads"]]


def _fails(numbers: dict, limits: dict) -> bool:
    return not harness.judge(numbers, limits)[0]


def _readings(run):
    return calibrate.train_readings(run, registry.driver(run.mix["driver"]))


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_far_above_the_program_at_a_tiny_size(workload):
    rd = _readings(tiny_run(workload)[0])
    for reading in ("control", "half"):
        assert rd[reading]["grad_gap"] > 100 * max(rd["program"]["grad_gap"],
                                                   1e-9)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(workload, card):
    import argparse
    lim = registry.limits(workload)
    for k in range(3):
        args = argparse.Namespace(workload=workload, seed=5_000_000_029
                                  + 104_729 * k, seconds=5.0, trace=0)
        rd = _readings(harness.Run(MAN, workload, args, card))
        assert not _fails(rd["program"], lim), rd
        assert _fails(rd["control"], lim), rd
        assert _fails(rd["half"], lim), rd
