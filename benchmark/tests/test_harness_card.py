"""On the card: a short run of each cell comes out correct, and the
control at the cell's own size comes out not correct. Skips without a
card."""

import time

import pytest

from benchmark import control
from benchmark import run as brun
from benchmark.registry import Registry

CELLS = [w["name"] for w in Registry().spec["workloads"]]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cuda, cell):
    reg = Registry()
    res = brun.run(reg, reg.workload(cell), 2 ** 31 + 101, 2.0, False,
                   device=cuda, t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["failed"] == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cuda, cell):
    rows = control.readings(Registry(), cell, 2 ** 31 + 102, cuda,
                            variants=("tf32",))
    assert not rows[1]["correct"], rows[1]
