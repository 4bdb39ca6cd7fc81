"""The joint-fit cell (fire_joint.train, driver joint_fit) on the CPU at its
own tiny sizes: the cell run traced and not, `correct` and its metric names;
the control and every fault planted in the reference reading not correct;
the emissive roofline's counts; the fold span's reader on a hand-built
trace; and the emission reference's forward walk against walk.py's."""
import json
import os

import pytest
import torch

from benchmark import harness, profiling, roofline, roofline_emission, run, span_report
from benchmark.drivers import joint_fit as jf
from benchmark.reference import emission, walk

CELL = "fire_joint.train"
# fire_plume(16, 5) at voxel 1 (15 x 16 x 15), 8 x 8 pixels x 4 samples, 3 views;
# n_iters 512 bounds the bfloat16 control's walk, whose lanes stall until the cap
SIZES = {"config": {"volume": {"height": 16, "radius": 5.0, "voxel_size": 1.0}, "fit": {"n_iters": 512}},
         "mix": {"pixels": [8, 8], "ring_radius": 40.0, "ring_height": 8.0, "look": [0.0, 8.0, 0.0], "views": 3,
                 "restore_every": 2}}
SEED = 2 ** 31 + 977
NEW = ("record_kernel_roofline.emissive", "replay_kernel_roofline.emissive", "step_idle_ms.fold")


def _reader(name):
    return run._reader(os.path.join(run.ROOT, "benchmark", "metrics", name + ".py"))


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_tiny_on_the_cpu(trace, monkeypatch):
    monkeypatch.setattr(harness, "Run", span_report._Kept)
    res = run.run_cell(CELL, SEED, 0.3, trace, device_type="cpu", sizes=SIZES)
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"loss_gap", "grad_norm_gap.density", "grad_norm_gap.temperature",
                                  "update_norm_gap.density", "update_norm_gap.temperature"}
    assert all(c["value"] < c["limit"] / 100 for c in res["checks"].values()), res["checks"]
    c = run.Cell(CELL)
    got = set(res["metrics"])
    if not trace:
        assert got == {"train_rays_per_s", "setup_s"}  # peak_mem_gb: no card
        return
    assert got <= {m["name"] for m in c.per_layer} and set(NEW) <= {m["name"] for m in c.per_layer}
    assert {"medium_build_s", "step_span_ms", "syncs_per_step", "launches_per_step"} - got == {"launches_per_step"}
    assert not got & set(NEW)  # no device records on the CPU: no roofline share, no idle
    r = span_report._Kept.last
    w = r.work["record"]
    assert isinstance(w, roofline_emission.Work) and r.work["replay"] is w
    assert w.lanes == 8 * 8 * 4 and 0 < w.emissive <= w.lane_steps and w.tcorners > 0 and w.corners > 0
    json.dumps(res)


def test_control_and_every_fault_read_not_correct():
    c = run.Cell(CELL, sizes=SIZES)
    readings = jf.control(c, SEED, torch.device("cpu"))
    assert set(readings) == {"control", "half", *emission.FAULTS}
    for what, numbers in readings.items():
        assert any(v > c.limits[k] for k, v in numbers.items()), (what, numbers)
    assert readings["no_temperature_grad"]["grad_norm_gap.temperature"] == 1.0
    assert readings["value_for_slope"]["loss_gap"] == 0.0  # the forward is untouched


def test_emissive_bound_arithmetic():
    w = roofline_emission.Work(lanes=1000, lane_steps=10_000, corners=100, pairs=10, tcorners=40, emissive=3000)
    rec, rep = roofline_emission.record(w), roofline_emission.replay(w)
    base_rec, base_rep = roofline.record(w), roofline.replay(w)
    assert rec.ops == 10_000 * 150 + 1000 * 80 + 3000 * 56 == base_rec.ops + 3000 * 56
    assert rec.bytes == 1000 * (32 + 16) + 100 * 32 + 10 * 8 + 40 * 32
    assert rep.ops == 10_000 * 200 + 1000 * 80 + 3000 * 83
    assert rep.bytes == base_rep.bytes + 2 * 40 * 32
    assert rec.seconds == max(rec.ops / 67e12, rec.bytes / 3.35e12)
    assert roofline.share_percent(rep, 2, 4 * rep.seconds) == 50.0


def test_first_step_counts_are_the_walks():
    """The counts come from the reference's walk of the first step's batch,
    whole; the emissive collisions are camera-path real collisions."""
    c = run.Cell(CELL, sizes=SIZES)
    dens, temp, p0, targets = jf.inputs(c.config, c.mix, SEED, "cpu")
    job = jf.fit(c.config, c.mix)
    r = emission.reference_steps(job, dens, temp, p0, temp.data, targets, SEED, 1, "cpu", measure=True)
    n = r.counts
    assert n["lanes"] == 256 and 0 < n["emissive"] < n["lane_steps"]
    for grid, key in ((dens, "corners"), (temp, "tcorners")):
        X, Y, Z = grid.data.shape
        assert 0 < n[key] <= (X + 1) * (Y + 1) * (Z + 1), key
    assert emission.reference_steps(job, dens, temp, p0, temp.data, targets, SEED, 1, "cpu").counts is None


def test_forward_is_walk_py_s():
    """emission.walk's forward is walk.py's walk, bit for bit, and its shadow
    slots hold what walk.py records in as many slots."""
    c = run.Cell(CELL, sizes=SIZES)
    dens, temp, _, _ = jf.inputs(c.config, c.mix, SEED, "cpu")
    job = jf.fit(c.config, c.mix)
    vol = walk.Volume(dens, job.transport, temp, bloat=0.1)
    cam = walk.Pinhole(job.cameras[1], job.look, job.up, job.vfov_deg, 8, 8, "cpu")
    pids = torch.arange(64).repeat(2)
    streams = torch.tensor([walk.stream_word(SEED, j) for j in range(2)]).repeat_interleave(64)
    o, d = cam.rays(pids, streams, 0.5)
    ours = emission.walk(vol, o, d, pids, streams, 512)
    k = ours.t_final.shape[1]
    theirs = walk.walk(vol, o, d, pids, streams, 512, record_walks=k)
    assert torch.equal(ours.L, theirs.L) and torch.equal(ours.steps, theirs.steps)
    assert torch.equal(ours.t_final, theirs.t_final) and bool((ours.t_final != 0).any())


def _fold_trace(with_fold=True, with_device=True):
    """Two steps in a window of 1000 us; a step's replay (160-290) ends in its
    fold (250-290), the device busy 160-260 and 265-270 of each step."""
    cpu, device = [], []
    for t in (0, 500):
        cpu += [("train.step", t + 100, t + 400), ("train.backward", t + 150, t + 300),
                ("prb.replay", t + 160, t + 290)]
        if with_fold:
            cpu.append(("prb.fold", t + 250, t + 290))
        device += [(0, "k", t + 160, t + 260), (0, "k", t + 265, t + 270)]
    r = harness.Run([torch.device("cuda", 0)], (0.0, 0.0))
    r.kind = "train"
    r.trace = profiling.Trace(0.0, 1000.0, device if with_device else [], cpu, {})
    return r


def test_fold_idle_reader():
    read = _reader("step_idle_ms.fold")
    assert read(_fold_trace()) == pytest.approx(0.025)  # a fold's 40 us less 10 + 5 busy
    assert read(_fold_trace(with_fold=False)) is None  # a program without the span
    assert read(_fold_trace(with_device=False)) is None  # no device records (the CPU)
    r = _fold_trace()
    r.kind = "render"
    assert read(r) is None
