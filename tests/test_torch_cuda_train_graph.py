"""The train step as one CUDA graph on the card (diff/inverse.py StepGraph).

Runs only where CUDA is; elsewhere every test skips (on the card:
`python -m pytest --noconftest tests/test_torch_cuda_*.py`). This file
imports neither JAX nor the JAX package: the reference is the step's own
eager body (`step.graph.body`, the code the graph captured), run on copies
of the same state; tests/test_torch_train_graph.py holds the graph's rules
on the CPU.

On a small dense emissive medium, the dual-buffer loss, 3 views x 5 steps:

- each replayed step equals the eager body from the same state: the loss
  (the forward has no atomics), both leaves' update and both Adam moments
  to the tolerance of the replay's float atomics (they add in another order
  on every run);
- each step object captures once (view 0 at its second call, after the
  eager first step made Adam's state; views 1 and 2 at their first);
- a target changed in place is read as it is (no capture); a new target
  tensor, load_train_checkpoint and a changed learning rate each give a
  correct step, counted as a capture;
- a replayed step waits for nothing (torch.cuda.set_sync_debug_mode
  "error"), and loss_rays under a graph takes each replay's seed and wave
  from the device words.
"""
import numpy as np
import pytest
import torch

from volume_path_tracer_tpu_torch.diff import inverse as inv
from volume_path_tracer_tpu_torch.grids.procedural import fire_plume
from volume_path_tracer_tpu_torch.models.camera import Camera
from volume_path_tracer_tpu_torch.models.medium import Medium
from volume_path_tracer_tpu_torch.render import megakernel as tmk
from volume_path_tracer_tpu_torch.render.integrator import IntegratorParams
from volume_path_tracer_tpu_torch.utils.config import CameraParameters
from volume_path_tracer_tpu_torch.utils.spectral import blackbody_xyz_table

pytestmark = pytest.mark.cuda

W, H, K = 32, 24, 4
VIEWS, ROUNDS = 3, 5
SEED = 0xC0FFEE17
FIRE = IntegratorParams(
    sigma_a=2.0, sigma_s=0.9, hg_g=0.7, le_scale=4e-8, temperature_offset=300.0, temperature_scale=43.0,
    infinite_xyz=(0.25, 0.25, 0.5), infinite_multiplier=10.0, distant_xyz=(0.95047, 1.0, 1.08883),
    distant_multiplier=20.0, distant_inv_direction=(0.5, 1.0, 0.0), max_depth=1_000_000, max_iters=512,
)
# The replay adds with float atomics: its gradient differs from run to run
# in the last bits, and Adam's moments with it. The update lr * m / sqrt(v)
# moves a voxel by nearly lr whatever its gradient's size, so a voxel whose
# gradient sums to about 0 may move the other way: a few may differ.
MOMENT_RTOL = 1e-4
UPDATE_APART = 1e-3  # the share of voxels whose update may differ by over 1e-3 lr


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _fit(dev):
    """(base medium, one step per view, raster, pids, targets [VIEWS, W * H, 3])."""
    dens, temp = fire_plume(height=24, radius=6.0)
    base = Medium.from_grids(dens, temp, pack=False, device=dev)
    g = base.density
    lo = np.asarray(g.world_offset) + np.asarray(g.origin_ijk) * g.voxel_size
    mid = lo + np.asarray(g.shape) * g.voxel_size / 2
    r = 2.5 * float(np.asarray(g.shape).max() * g.voxel_size)
    bb = torch.from_numpy(blackbody_xyz_table()).to(dev)
    steps = []
    for v in range(VIEWS):
        a = 2 * np.pi * v / VIEWS
        pos = tuple(float(x) for x in mid + r * np.array([np.cos(a), 0.0, np.sin(a)]))
        cam = Camera.from_parameters(CameraParameters(pos, tuple(float(x) for x in mid), (0.0, 1.0, 0.0), 40.0, 0.1),
                                     (W, H), device=dev)
        steps.append(inv.make_train_step(base, FIRE, cam, bb, n_iters=128, samples_per_step=K, dual_buffer=True))
    ys, xs = np.mgrid[0:H, 0:W]
    raster = torch.from_numpy(np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)).to(dev)
    pids = torch.arange(W * H, dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(7)
    targets = (0.02 * torch.rand((VIEWS, W * H, 3), generator=gen)).to(dev)
    return base, steps, raster, pids, targets


def _start(base):
    grids = inv.OptimizableGrids(inv.param_from_density(base.density.data).clone().requires_grad_(True),
                                 base.temperature.data.clone().requires_grad_(True))
    return grids, inv.make_optimizer(grids)


def _copy(grids, opt):
    """The same state in new tensors, with a capturable Adam of its own."""
    g2 = inv.OptimizableGrids(*(x.detach().clone().requires_grad_(True) for x in grids))
    o2 = inv.make_optimizer(g2, lr=opt.param_groups[0]["lr"])
    for p, q in zip(inv.grid_leaves(grids), inv.grid_leaves(g2)):
        if p in opt.state:
            o2.state[q] = {k: v.clone() for k, v in opt.state[p].items()}
    return g2, o2


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _checked_step(step, grids, opt, raster, pids, target, sw):
    """One step through `step` and, from a copy of the same state, one through
    its eager body; the two are held together. Returns the step's loss."""
    g2, o2 = _copy(grids, opt)
    before = [x.detach().clone() for x in inv.grid_leaves(grids)]
    sq, n = step.graph.body(g2, o2, raster, pids, target, sw)
    want = sq.detach() / n
    grids, opt, loss = step(grids, opt, raster, pids, target, sw)
    torch.cuda.synchronize()
    assert rel_l2(loss, want) <= 1e-6, (float(loss), float(want))
    lr = opt.param_groups[0]["lr"]
    for p, q, p0 in zip(inv.grid_leaves(grids), inv.grid_leaves(g2), before):
        assert float((q.detach() - p0).abs().max()) > 0  # the step moved the leaf
        apart = float(((p.detach() - q.detach()).abs() > 1e-3 * lr).double().mean())
        assert apart <= UPDATE_APART, f"{apart} of the voxels updated apart"
        for k in ("exp_avg", "exp_avg_sq"):
            d = rel_l2(opt.state[p][k], o2.state[q][k])
            assert d <= MOMENT_RTOL, f"{k} rel L2 {d}"
        assert torch.equal(opt.state[p]["step"], o2.state[q]["step"])
    return loss


def test_replayed_steps_match_the_eager_body(dev):
    base, steps, raster, pids, targets = _fit(dev)
    grids, opt = _start(base)
    for i in range(VIEWS * ROUNDS):
        v = i % VIEWS
        loss = _checked_step(steps[v], grids, opt, raster, pids, targets[v], (SEED, i))
        assert bool(torch.isfinite(loss))
        if i > 0:  # every step after the first leaves its gradient in the graph's pool
            assert all(p.grad is None for p in inv.grid_leaves(grids))
    assert [s.graph.captures for s in steps] == [1, 1, 1]
    assert [s.graph.replays for s in steps] == [ROUNDS - 1, ROUNDS, ROUNDS]


def test_new_inputs_and_state_are_read_or_captured(dev, tmp_path):
    base, steps, raster, pids, targets = _fit(dev)
    step = steps[0]
    grids, opt = _start(base)
    g = step.graph
    _checked_step(step, grids, opt, raster, pids, targets[0], (SEED, 0))  # eager: Adam's state made
    _checked_step(step, grids, opt, raster, pids, targets[0], (SEED, 1))
    assert (g.captures, g.replays) == (1, 1)
    _checked_step(step, grids, opt, raster, pids, targets[0], (SEED, 2))  # a new view of the same target
    assert (g.captures, g.replays) == (1, 2)
    other = targets[1].clone()
    _checked_step(step, grids, opt, raster, pids, other, (SEED, 3))
    assert (g.captures, g.replays) == (2, 3)
    other.mul_(1.5)  # changed in place: the graph reads it as it is now
    _checked_step(step, grids, opt, raster, pids, other, (SEED, 4))
    assert (g.captures, g.replays) == (2, 4)
    path = str(tmp_path / "ckpt.npz")
    inv.save_train_checkpoint(path, grids, opt, 5)
    grids, opt, _ = inv.load_train_checkpoint(path, grids, opt)
    assert all(opt.state[p]["step"].device == p.device for p in inv.grid_leaves(grids))
    _checked_step(step, grids, opt, raster, pids, other, (SEED, 5))
    assert (g.captures, g.replays) == (3, 5)
    for group in opt.param_groups:
        group["lr"] = 0.02
    _checked_step(step, grids, opt, raster, pids, other, (SEED, 6))
    _checked_step(step, grids, opt, raster, pids, other, (SEED, 7))
    assert (g.captures, g.replays) == (4, 7)


def test_replayed_steps_do_not_sync(dev):
    base, steps, raster, pids, targets = _fit(dev)
    grids, opt = _start(base)
    for i in range(VIEWS + 1):  # the eager first step, then every view's capture
        steps[i % VIEWS](grids, opt, raster, pids, targets[i % VIEWS], (SEED, i))
    torch.cuda.synchronize(dev)
    captures = [s.graph.captures for s in steps]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(VIEWS + 1, 3 * VIEWS):
            grids, opt, loss = steps[i % VIEWS](grids, opt, raster, pids, targets[i % VIEWS], (SEED, i))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    assert [s.graph.captures for s in steps] == captures
    assert sum(s.graph.replays for s in steps) == 3 * VIEWS - 1  # every step but the eager first
    assert bool(torch.isfinite(loss))


def test_loss_rays_reads_the_words_at_replay(dev):
    _, steps, raster, pids, _ = _fit(dev)
    cam = Camera.from_parameters(CameraParameters((20.0, 3.0, -4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 40.0, 0.1),
                                 (W, H), device=dev)
    words = torch.zeros((1,), dtype=torch.int64, device=dev)
    tmk.loss_rays(cam, raster, pids, words.view(torch.int32), K, True)  # the library loaded outside the capture
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        graph.capture_begin()
        out = tmk.loss_rays(cam, raster, pids, words.view(torch.int32), K, True)
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    for seed, wave in ((SEED, 2**32 - 1), (3, 1), (2**31, 2**31 + 5)):
        word = wave << 32 | seed
        words.fill_(word - (word >> 63 << 64))
        graph.replay()
        want = tmk.loss_rays(cam, raster, pids, (seed, wave), K, True)
        torch.cuda.synchronize(dev)
        for a, b in zip(out, want):
            assert torch.equal(a, b)
