"""The control, the reference computed in bfloat16 in the program's place,
comes out not correct under each cell's limits (at a size a test run holds;
the chip readings at the cells' own sizes are in PERF.md)."""
import pytest
import torch

from benchmark import run
from benchmark.tests import sizes


@pytest.mark.parametrize("cell", ["wdas_cloud.render", "fire.render", "wdas_cloud.train"])
def test_control_fails_a_limit(cell):
    c = run.Cell(cell, sizes=sizes.CELLS[cell])
    readings = run.driver(c.mix["driver"]).control(c, sizes.SEED, torch.device("cpu"))
    for what, numbers in readings.items():
        assert any(v > c.limits[k] for k, v in numbers.items()), (what, numbers)
