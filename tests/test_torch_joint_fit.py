"""The port's joint density-and-temperature train step on the CPU, held to
the plain reference of the emissive fit (benchmark/reference/emission.py).

On a tiny seeded plume (fire_plume(16, 5) at voxel 1, 15 x 16 x 15 voxels),
8 x 8 pixels x 4 samples a step with the dual-buffer loss, the port's step
(inverse.make_train_step(..., dual_buffer=True) over OptimizableGrids(log
density, temperature), its plain record and replay) and the reference take
two steps from the same grids, views, targets and draws: the losses, both
leaves' first gradients and both leaves after the two Adam steps agree.
Temperature changes no sampling probability, so with the draws fixed the
radiance is piecewise linear in each temperature voxel: the reference's
temperature gradient equals central differences of its own forward. A port
whose temperature gradient is zeroed reads outside the tolerances.
"""
import pytest
import torch

from benchmark import run
from benchmark.drivers import joint_fit as jf
from benchmark.reference import emission as ref
from benchmark.reference.walk import Grid, Pinhole, Volume, stream_word
from volume_path_tracer_tpu_torch.render import megakernel

SIZES = {"config": {"volume": {"height": 16, "radius": 5.0, "voxel_size": 1.0}},
         "mix": {"pixels": [8, 8], "ring_radius": 40.0, "ring_height": 8.0, "look": [0.0, 8.0, 0.0], "views": 3}}
SEEDS = [2 ** 31 + 977, 3_150_000_013]
STEPS = 2

# Relative tolerances. Both sides follow the same draws in float32, so they
# walk the same paths; what differs is the order of float sums (the port
# scatters into corner rows and folds them, the reference scatters into a
# padded grid; the loss and Adam sum in other orders): measured gaps are
# 1e-8 to 1e-7, and these leave 100x room. Zeroing a leaf's gradient reads
# 1.0 on that leaf.
TOL = {"loss": 1e-5, "grad": 1e-5, "update": 1e-5}


def _cell():
    return run.Cell("fire_joint.train", sizes=SIZES)


def _port(cell, seed):
    """(losses, first gradients, leaves after STEPS, leaves at the start) of the port's own steps."""
    dens, temp, p0, targets = jf.inputs(cell.config, cell.mix, seed, "cpu")
    prog = jf.JointProgram(cell.config, cell.mix, dens, temp, p0, targets, seed, [torch.device("cpu")])
    losses, first = [], None
    for i in range(STEPS):
        losses.append(float(prog.step(i)))
        if i == 0:
            first = {q: g.clone() for q, g in prog.first_gradients().items()}
    return losses, first, {q: p.detach().clone() for q, p in prog.leaves.items()}, {"density": p0, "temperature": temp.data}


def _reference(cell, seed, **kw):
    dens, temp, p0, targets = jf.inputs(cell.config, cell.mix, seed, "cpu")
    return ref.reference_steps(jf.fit(cell.config, cell.mix), dens, temp, p0, temp.data, targets, seed, STEPS,
                               "cpu", **kw)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _gaps(port, r: ref.Steps):
    losses, first, leaves, _ = port
    out = {"loss": max(abs(a - b) / abs(b) for a, b in zip(losses, r.losses))}
    for q in ref.LEAVES:
        out["grad." + q] = _rel(first[q], r.first[q])
        out["update." + q] = _rel(leaves[q], r.updated[q])
    return out


def _outside(gaps):
    return [k for k, v in gaps.items() if v > TOL[k.split(".")[0]]]


@pytest.fixture(scope="module", params=SEEDS)
def pair(request):
    cell = _cell()
    return _port(cell, request.param), _reference(cell, request.param)


def test_port_joint_step_matches_the_reference(pair):
    port, r = pair
    assert all(x > 0 for x in r.losses)
    for q in ref.LEAVES:
        assert r.grad_norms[q] > 0 and r.update_norms[q] > 0, q
    gaps = _gaps(port, r)
    assert _outside(gaps) == [], gaps


def test_benchmark_numbers_agree(pair):
    """joint_numbers, which decides the cell's `correct`, reads the same pair
    as close: every number under a hundredth of the cell's limit."""
    (losses, first, leaves, start), r = pair
    cell = _cell()
    prog = ref.Steps(losses, {q: float(first[q].double().norm()) for q in ref.LEAVES},
                     {q: float((leaves[q] - start[q]).double().norm()) for q in ref.LEAVES}, None)
    for k, v in ref.joint_numbers(prog, r).items():
        assert v < cell.limits[k] / 100, (k, v)


def test_zeroed_temperature_gradient_reads_outside(monkeypatch):
    """A planted fault: the port's replay hands back a zero temperature gradient."""
    replay = megakernel.replay_lanes

    def broken(*a, **k):
        d_density, d_temp, *rest = replay(*a, **k)
        return (d_density, torch.zeros_like(d_temp), *rest)

    monkeypatch.setattr(megakernel, "replay_lanes", broken)
    cell = _cell()
    gaps = _gaps(_port(cell, SEEDS[0]), _reference(cell, SEEDS[0]))
    assert gaps["grad.temperature"] == pytest.approx(1.0)
    assert "grad.temperature" in _outside(gaps) and "update.temperature" in _outside(gaps)
    assert gaps["grad.density"] <= TOL["grad"]


@pytest.mark.parametrize("view", [0, 1])
def test_reference_temperature_gradient_is_central_differences(view):
    """In float64, for the five voxels of largest gradient: (f(t + h) - f(t - h))
    / 2h of <g, L> at fixed draws equals the replay's gradient. h = 2^-10 is
    exact in float32, the precision the reference's tables hold the grid in,
    and moves no collision's kelvin across a table slot (0.04 K of 100 K).
    The difference's roundoff scales with f (about 50 here), not with one
    voxel's gradient, so the tolerance is a millionth of the largest one."""
    cell = _cell()
    job = jf.fit(cell.config, cell.mix)
    seed = SEEDS[0]
    dens, temp, _, _ = jf.inputs(cell.config, cell.mix, seed, "cpu")
    dt = torch.float64
    w, h = job.pixels
    k = job.samples
    cam = Pinhole(job.cameras[view], job.look, job.up, job.vfov_deg, w, h, "cpu", dt)
    pids = torch.arange(w * h).repeat(k)
    streams = torch.tensor([stream_word(seed, j) for j in range(k)]).repeat_interleave(w * h)
    o, d = cam.rays(pids, streams, 0.5)
    g = torch.randn((pids.shape[0], 3), generator=torch.Generator().manual_seed(view), dtype=dt)

    def volume(t):
        return Volume(dens, job.transport, Grid(t, temp.origin, temp.voxel, temp.offset), bloat=job.bloat, dtype=dt)

    def f(t):
        return float((g * ref.walk(volume(t), o, d, pids, streams, job.n_iters).L).sum())

    fw = ref.walk(volume(temp.data), o, d, pids, streams, job.n_iters)
    grad = ref.walk(volume(temp.data), o, d, pids, streams, job.n_iters,
                    replay=(g, fw.L, fw.t_final)).grad_temperature.reshape(-1)
    step = 2.0 ** -10
    top = torch.topk(grad.abs(), 5)
    for i in top.indices.tolist():
        up, down = temp.data.double().clone().reshape(-1), temp.data.double().clone().reshape(-1)
        up[i] += step
        down[i] -= step
        fd = (f(up.view_as(temp.data)) - f(down.view_as(temp.data))) / (2 * step)
        assert fd == pytest.approx(float(grad[i]), rel=1e-6, abs=1e-6 * float(top.values[0])), i
