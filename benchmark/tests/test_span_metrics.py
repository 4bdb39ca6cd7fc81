"""The readers of the port's spans (benchmark/spans.py and the metrics that
read it): exact values on a hand-built trace whose spans, device records and
sync calls are known, the step's idle partition adding up to the window's
idle, nothing from a program without the spans, and each cell's tiny
traced run on the CPU (the span metrics are numbers, the idle ones absent:
the CPU has no device records)."""
import json
import os

import pytest
import torch

from benchmark import harness, profiling, run, span_report, spans
from benchmark.tests import sizes

SPAN_METRICS = ("wave_span_ms", "wave_idle_ms.in_program", "step_span_ms", "step_idle_ms.rebuild",
                "step_idle_ms.rays", "step_idle_ms.record", "step_idle_ms.backward", "step_idle_ms.optimizer",
                "syncs_per_step")
READERS = {m: run._reader(os.path.join(run.ROOT, "benchmark", "metrics", m + ".py")) for m in SPAN_METRICS}

# One train step, in microseconds from its start: its phases, the device's
# records (two overlap: merged, as busy_s merges them) and a sync call.
STEP = [("train.step", 0, 300), ("train.optimizer", 0, 10), ("train.rebuild", 10, 50), ("train.rays", 50, 70),
        ("prb.record", 70, 150), ("train.backward", 150, 250), ("prb.replay", 160, 240),
        ("train.optimizer", 260, 300), ("aten::add", 20, 25)]
STEP_KERNELS = [(20, 40), (100, 140), (130, 145), (160, 240), (265, 295)]
# idle a step, microseconds: rebuild 40 - 20, rays 20, record 80 - 45, backward 100 - 80, optimizer 10 + (40 - 30)
STEP_IDLE = {"rebuild": 20, "rays": 20, "record": 35, "backward": 20, "optimizer": 20}


def _run(kind, cpu, device, calls=None, n_dev=1):
    r = harness.Run([torch.device("cuda", i) for i in range(n_dev)], (0.0, 0.0))
    r.kind = kind
    r.trace = profiling.Trace(0.0, 1000.0, device, cpu, calls or {})
    return r


def _train_trace(with_device=True):
    cpu, device = [], []
    for t in (-400, 100, 500):  # a warm-up step before the window, then two in it
        cpu += [(n, t + s, t + e) for n, s, e in STEP]
        device += [(0, "k", t + s, t + e) for s, e in STEP_KERNELS]
    cpu += [("cudaStreamSynchronize", 300, 301), ("cudaDeviceSynchronize", 450, 451),
            ("cudaEventSynchronize", 700, 701), ("cudaStreamSynchronize", -200, -199)]
    device.append((0, "k", 1100, 1200))  # after the window
    return _run("train", cpu, device if with_device else [])


def test_train_readers_exact():
    r = _train_trace()
    got = {m: READERS[m](r) for m in SPAN_METRICS}
    assert got["step_span_ms"] == pytest.approx(0.3)
    assert got["syncs_per_step"] == 1.0  # two of the four calls start inside the window's two steps
    for k, us in STEP_IDLE.items():
        assert got["step_idle_ms." + k] == pytest.approx(us * 1e-3), k
    assert got["wave_span_ms"] is None and got["wave_idle_ms.in_program"] is None


def test_train_idle_partition_adds_up():
    r = _train_trace()
    part = spans.step_partition(r.trace, r.device_ids)
    busy = profiling.busy_s(r.trace, r.device_ids)[0]
    assert part["window"] == pytest.approx(1e-3 - busy)
    assert busy == pytest.approx(2 * 175e-6)
    assert part["unphased"] == pytest.approx(2 * 10e-6)  # the gap between the backward and the optimizer
    assert part["outside"] == pytest.approx(part["window"] - 2 * 125e-6)
    for k, us in STEP_IDLE.items():
        assert part[k] == pytest.approx(2 * us * 1e-6)
    assert sum(v for k, v in part.items() if k != "window") == pytest.approx(part["window"])


def test_render_readers_exact_and_averaged_over_cards():
    cpu = [("render.wave", 100, 300), ("render.film", 105, 110), ("render.launch", 120, 140),
           ("render.wave", 400, 600), ("render.wave", 1100, 1200)]  # the last starts after the window
    device = [(0, "render_wave_kernel", 150, 280), (0, "render_wave_kernel", 420, 590)]
    r = _run("render", cpu, device)
    assert READERS["wave_span_ms"](r) == pytest.approx(0.2)
    assert READERS["wave_idle_ms.in_program"](r) == pytest.approx((70 + 30) / 2 * 1e-3)
    mesh = [(n.replace("render", "shard"), s, e) for n, s, e in cpu]
    device.append((1, "render_wave_kernel", 100, 300))  # card 1 busy through the first wave
    r = _run("render", mesh, device, n_dev=2)
    assert READERS["wave_span_ms"](r) == pytest.approx(0.2)
    assert READERS["wave_idle_ms.in_program"](r) == pytest.approx(((70 + 30) + (0 + 200)) / 2 / 2 * 1e-3)
    assert all(READERS[m](r) is None for m in SPAN_METRICS if m.startswith(("step", "syncs")))


def test_no_spans_no_reading():
    """A program without the spans (the parent of the spans' change) gives no reading, and no error."""
    r = _train_trace()
    gone = {spans.STEP, *spans.PHASES.values()}
    r.trace = r.trace._replace(cpu=[c for c in r.trace.cpu if c[0] not in gone])
    assert all(READERS[m](r) is None for m in SPAN_METRICS)
    r.kind = "render"
    assert all(READERS[m](r) is None for m in SPAN_METRICS)


def test_no_device_records_no_idle_reading():
    r = _train_trace(with_device=False)
    assert READERS["step_span_ms"](r) == pytest.approx(0.3) and READERS["syncs_per_step"](r) == 1.0
    assert all(READERS["step_idle_ms." + k](r) is None for k in STEP_IDLE)
    assert spans.step_partition(r.trace, r.device_ids) is None


@pytest.mark.parametrize("cell", sorted(sizes.CELLS))
def test_tiny_traced_run_on_the_cpu(cell, monkeypatch):
    """The cell's traced line has the span metrics, and span_report's table
    counts every window unit once."""
    monkeypatch.setattr(harness, "Run", span_report._Kept)
    res = run.run_cell(cell, sizes.SEED, 0.3, True, device_type="cpu", sizes=sizes.CELLS[cell])
    assert res["correct"] is True, res["checks"]
    got = res["metrics"]
    if cell == "wdas_cloud.train":
        assert got["step_span_ms"]["value"] > 0 and got["syncs_per_step"]["value"] == 0.0
        assert got["syncs_per_step"]["unit"] == "calls"
    else:
        assert got["wave_span_ms"]["value"] > 0 and got["wave_span_ms"]["unit"] == "ms"
    assert not any(m.startswith(("wave_idle_ms", "step_idle_ms")) for m in got)
    rep = span_report.report(span_report._Kept.last, 2)
    assert sum(p["units"] for p in rep["parts"]) == rep["units"] == res["attempted"]
    top = "train.step" if cell == "wdas_cloud.train" else "shard.wave" if cell.endswith("4gpu") else "render.wave"
    assert all(p["spans"][top]["count"] == 1.0 for p in rep["parts"] if p["units"])
    json.dumps(rep)
