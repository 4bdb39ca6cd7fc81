"""The train step's CUDA graph (diff/inverse.py StepGraph) off the card.

The graph runs only on CUDA leaves; tests/test_torch_cuda_train_graph.py
holds it to the eager body on the card. Here, on the CPU:

- the steps that can never be a graph hold none (a mesh, the autograd
  oracle, packed media), and a step on CPU leaves never captures;
- make_optimizer is capturable only on CUDA leaves, and
  load_train_checkpoint gives a capturable optimizer its step count on the
  leaf's device (meta leaves stand in for a card);
- what the graph bakes in (its key) changes with the learning rate, with
  new state tensors and with another input tensor, and not with state
  restored in place or a new view of the same target;
- loss_rays_plain takes the seed and wave as the device words the graph
  writes (an int32 [2] tensor of their uint32 bits) and gives the batch of
  the two ints bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

from volume_path_tracer_tpu_torch.diff import inverse as inv
from volume_path_tracer_tpu_torch.grids.procedural import fog_sphere
from volume_path_tracer_tpu_torch.models.camera import Camera
from volume_path_tracer_tpu_torch.models.medium import Medium
from volume_path_tracer_tpu_torch.parallel import shard
from volume_path_tracer_tpu_torch.render import megakernel as tmk
from volume_path_tracer_tpu_torch.render.integrator import IntegratorParams
from volume_path_tracer_tpu_torch.utils.config import CameraParameters

torch.set_num_threads(2)

W, H = 8, 6
PARAMS = IntegratorParams(
    sigma_a=0.05, sigma_s=0.3, hg_g=0.4, le_scale=0.0, temperature_offset=300.0, temperature_scale=40.0,
    infinite_xyz=(0.25, 0.25, 0.5), infinite_multiplier=1.0, distant_xyz=(0.95, 1.0, 1.09),
    distant_multiplier=5.0, distant_inv_direction=(0.5, 1.0, 0.0), max_depth=40, max_iters=96,
)


@functools.lru_cache(maxsize=None)
def _scene():
    base = Medium.from_grids(fog_sphere(radius=4.0, falloff=2.0), pack=False, device="cpu")
    camera = Camera.from_parameters(CameraParameters((18.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 38.0, 0.5),
                                    (W, H), device="cpu")
    ys, xs = np.mgrid[0:H, 0:W]
    raster = torch.from_numpy(np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32))
    return base, camera, raster, torch.arange(W * H, dtype=torch.int32)


def _grids(base):
    return inv.OptimizableGrids(inv.param_from_density(base.density.data).requires_grad_(True))


@pytest.mark.parametrize("kind", ["mesh", "autograd_oracle", "packed"])
def test_steps_that_cannot_be_a_graph_hold_none(kind):
    base, camera, _, _ = _scene()
    kw = {"mesh": dict(mesh=shard.make_mesh(2, 1, devices=["cpu"] * 2)),
          "autograd_oracle": dict(use_prb=False), "packed": dict(pack=True)}[kind]
    step = inv.make_train_step(base, PARAMS, camera, None, n_iters=32, samples_per_step=2, **kw)
    assert step.graph is None


def test_step_on_cpu_leaves_never_captures():
    base, camera, raster, pids = _scene()
    grids = _grids(base)
    opt = inv.make_optimizer(grids)
    step = inv.make_train_step(base, PARAMS, camera, None, n_iters=32, samples_per_step=2)
    target = torch.zeros((W * H, 3))
    for i in range(2):
        grids, opt, loss = step(grids, opt, raster, pids, target, (5, i))
        assert bool(torch.isfinite(loss))
    assert isinstance(step.graph, inv.StepGraph)
    assert not step.graph.applies(grids, opt, raster, pids, target)
    assert (step.graph.captures, step.graph.replays) == (0, 0)
    # the eager step keeps its gradient on the leaves
    assert grids.log_density.grad is not None


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_make_optimizer_capturable_only_on_cuda(device):
    leaf = torch.zeros((3, 4, 5), device=device, requires_grad=True)
    opt = inv.make_optimizer(inv.OptimizableGrids(leaf, torch.ones((2, 2, 2), device=device, requires_grad=True)))
    assert [g["capturable"] for g in opt.param_groups] == [False]
    assert [g["foreach"] for g in opt.param_groups] == [None]  # foreach by default, never fused
    assert not opt.param_groups[0]["fused"]


@pytest.mark.parametrize("capturable", [False, True], ids=["cpu_count", "count_on_the_leaf_device"])
def test_load_checkpoint_puts_a_capturable_count_on_the_leaf_device(tmp_path, capturable):
    src = inv.OptimizableGrids(torch.full((3, 4, 5), 0.5, requires_grad=True))
    path = str(tmp_path / "ckpt.npz")
    inv.save_train_checkpoint(path, src, inv.make_optimizer(src), 7)
    leaf = torch.empty((3, 4, 5), device="meta", requires_grad=True)  # stands in for a card
    opt = torch.optim.Adam([leaf], lr=1e-2, capturable=capturable)
    _, opt, step = inv.load_train_checkpoint(path, inv.OptimizableGrids(leaf), opt)
    st = opt.state[leaf]
    assert step == 7
    assert st["step"].device.type == ("meta" if capturable else "cpu")
    assert st["step"].dtype == torch.float32
    assert st["exp_avg"].device.type == st["exp_avg_sq"].device.type == "meta"


def test_graph_key_sees_what_a_capture_bakes_in():
    base, camera, raster, pids = _scene()
    grids = _grids(base)
    opt = inv.make_optimizer(grids)
    step = inv.make_train_step(base, PARAMS, camera, None, n_iters=32, samples_per_step=2)
    targets = torch.zeros((2, W * H, 3))
    grids, opt, _ = step(grids, opt, raster, pids, targets[0], (5, 0))  # Adam's state made
    key = inv.StepGraph._key(grids, opt, raster, pids, targets[0])
    # a new view of the same target, and state restored in place: the same graph
    saved = {k: v.clone() for k, v in opt.state[grids.log_density].items()}
    for k, v in opt.state[grids.log_density].items():
        v.copy_(saved[k])
    with torch.no_grad():
        grids.log_density.add_(1.0)
    assert inv.StepGraph._key(grids, opt, raster, pids, targets[0]) == key
    # the graph reads its inputs where they lie: another target (other
    # memory), another shape or layout, a new learning rate, new state
    # tensors: captured again
    assert inv.StepGraph._key(grids, opt, raster, pids, targets[1]) != key
    assert inv.StepGraph._key(grids, opt, raster, pids, targets[0].clone()) != key
    assert inv.StepGraph._key(grids, opt, raster[:-1], pids[:-1], targets[0][:-1]) != key
    assert inv.StepGraph._key(grids, opt, raster, pids, targets[0].t().contiguous().t()) != key
    opt.param_groups[0]["lr"] = 0.02
    assert inv.StepGraph._key(grids, opt, raster, pids, targets[0]) != key
    opt.param_groups[0]["lr"] = 1e-2
    assert inv.StepGraph._key(grids, opt, raster, pids, targets[0]) == key
    opt.state[grids.log_density] = saved
    assert inv.StepGraph._key(grids, opt, raster, pids, targets[0]) != key


@pytest.mark.parametrize("seed,wave", [(0xDEADBEEF, 2**32 - 1), (3, 1), (2**31, 2**31 + 5)],
                         ids=["high_words", "small", "sign_bits"])
def test_loss_rays_plain_takes_the_device_words(seed, wave):
    base, camera, raster, pids = _scene()
    want = tmk.loss_rays_plain(camera, raster, pids, (seed, wave), 3, True)
    word = wave << 32 | seed
    words = torch.tensor([word - (word >> 63 << 64)], dtype=torch.int64).view(torch.int32)
    got = tmk.loss_rays_plain(camera, raster, pids, words, 3, True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
