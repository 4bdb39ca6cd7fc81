"""The cell wdas_cloud.render.unpacked: the cloud rendered from its own dense
array. It runs the render cells' CPU tests at their tiny size
(sizes.RENDER): each test below calls the test of the same name in
test_cells_cpu.py, test_span_metrics.py, test_control.py or test_faults.py
with this cell added to sizes.CELLS for its length. And the cell's traced
line reads render_wave_kernel_roofline from the dense instantiation's
records as it reads the packed one's."""
import os

import pytest
import torch

from benchmark import harness, profiling, roofline, run
from benchmark.tests import sizes
from benchmark.tests import test_cells_cpu as cells_cpu
from benchmark.tests import test_control as control
from benchmark.tests import test_faults as faults
from benchmark.tests import test_span_metrics as span_metrics

CELL = "wdas_cloud.render.unpacked"
METRICS = os.path.join(run.ROOT, "benchmark", "metrics")
PACKED_NAME = "void (anonymous namespace)::render_wave_kernel<false, 0, false>(Args)"
DENSE_NAME = "void (anonymous namespace)::render_wave_kernel<false, 1, false>(Args)"


@pytest.fixture
def sized(monkeypatch):
    monkeypatch.setitem(sizes.CELLS, CELL, sizes.RENDER)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_tiny_on_the_cpu(sized, trace):
    cells_cpu.test_cell_runs_tiny_on_the_cpu(CELL, trace)


def test_tiny_traced_run_on_the_cpu(sized, monkeypatch):
    span_metrics.test_tiny_traced_run_on_the_cpu(CELL, monkeypatch)


def test_control_fails_a_limit(sized):
    control.test_control_fails_a_limit(CELL)


def test_sound_run_is_correct(sized):
    faults.test_sound_run_is_correct(CELL)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_wave_is_not_correct(sized, monkeypatch, kind):
    faults.test_broken_wave_is_not_correct(monkeypatch, CELL, kind)


def test_the_cell_is_the_packed_cells_scene_read_dense():
    dense, packed = run.Cell(CELL), run.Cell("wdas_cloud.render")
    words = ("source", "deployment", "assumed", "medium")
    assert {k: v for k, v in dense.config.items() if k not in words} == \
        {k: v for k, v in packed.config.items() if k not in words}
    assert dense.config["medium"] == {"pack": False} and "medium" not in packed.config
    assert dense.mix["medium"] == {"pack": False} and "medium" not in packed.mix
    assert {k: v for k, v in dense.mix.items() if k not in ("medium", "about")} == \
        {k: v for k, v in packed.mix.items() if k != "about"}
    assert {m["name"] for m in dense.per_layer} == {m["name"] for m in packed.per_layer}


def _run(names, seconds=1e-3):
    """A traced render run on one card whose window holds one record of each name."""
    r = harness.Run([torch.device("cuda", 0)], (0.0, 0.0))
    r.kind = "render"
    r.work["wave"] = roofline.Work(lanes=2_073_600, lane_steps=5.0e7, corners=400_000, pairs=20_000)
    recs = [(0, n, 10.0 + 2e3 * i, 10.0 + 2e3 * i + seconds * 1e6) for i, n in enumerate(names)]
    r.trace = profiling.Trace(0.0, 1e7, recs, [], {})
    return r


def test_roofline_reads_the_dense_records():
    read = run._reader(os.path.join(METRICS, "render_wave_kernel_roofline.py"))
    bound = roofline.wave(_run([]).work["wave"])
    dense = read(_run([DENSE_NAME, DENSE_NAME, "void at::native::fill_kernel"]))
    assert dense == pytest.approx(100.0 * bound.seconds / 1e-3)
    assert dense == pytest.approx(read(_run([PACKED_NAME, PACKED_NAME])))
