"""Shared inputs of the tests of the port's sharded paths (tests/test_torch_sharding*.py)."""
import dataclasses
import functools

import numpy as np
import torch

from volume_path_tracer_tpu.grids.grid import dense_grid_from_array as j_dense
from volume_path_tracer_tpu.grids.procedural import fog_sphere as j_fog_sphere
from volume_path_tracer_tpu.models.camera import Camera as JCamera
from volume_path_tracer_tpu.models.medium import Medium as JMedium
from volume_path_tracer_tpu.render import integrator as jint
from volume_path_tracer_tpu.utils.config import CameraParameters
from volume_path_tracer_tpu_torch.diff import inverse as tinv
from volume_path_tracer_tpu_torch.models.camera import Camera
from volume_path_tracer_tpu_torch.models.medium import medium_from_numpy
from volume_path_tracer_tpu_torch.parallel import shard
from volume_path_tracer_tpu_torch.render import integrator as tint
from volume_path_tracer_tpu_torch.render import megakernel as tmk
from volume_path_tracer_tpu_torch.utils import rng as trng

# tests/test_sharding.py's transport
PARAMS = dict(
    sigma_a=0.05, sigma_s=0.3, hg_g=0.4, le_scale=0.0,
    temperature_offset=300.0, temperature_scale=40.0,
    infinite_xyz=(0.25, 0.25, 0.5), infinite_multiplier=1.0,
    distant_xyz=(0.95, 1.0, 1.09), distant_multiplier=5.0,
    distant_inv_direction=(0.5, 1.0, 0.0),
    max_depth=40, max_iters=1024,
)


def cpu_mesh(n, spp=1):
    return shard.make_mesh(n, spp=spp, devices=["cpu"] * n)


@functools.lru_cache(maxsize=None)
def scene(width=24, height=16):
    """tests/test_sharding.py's _scene, for both packages from one numpy
    source: (JAX medium, camera, params), (the port's), width, height."""
    jmed = JMedium.from_grids(j_fog_sphere(radius=10.0))
    jcam = JCamera.from_parameters(
        CameraParameters((40.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 38.0, 0.5), (width, height))
    tmed = medium_from_numpy(j_fog_sphere(radius=10.0), device="cpu")
    tcam = Camera.from_numpy(jcam.position, jcam.raster_to_world_dir, jcam.raster_to_world_trans,
                             jcam.imaging_ratio, device="cpu")
    return ((jmed, jcam, jint.IntegratorParams(**PARAMS)), (tmed, tcam, tint.IntegratorParams(**PARAMS)),
            width, height)


def batch(W, H):
    raster, pids, npix = shard.pad_ray_batch(W, H, 8)
    assert npix == W * H == raster.shape[0]
    return raster, pids


def one_device_wave(med, cam, prm, W, H, seed, wave):
    """The port's wave on one device: render_wave over every pixel into a
    zero film, as [W * H, 4] rows."""
    film = torch.zeros((H, W, 4))
    tmk.render_wave(med, prm, cam, None, film, range(0, W * H), trng.mix_stream(seed, wave), True,
                    cam.imaging_ratio)
    return film.view(-1, 4)


def train_inputs(W=16, H=8):
    """tests/test_sharding.py's training inputs, with the log density
    starting at 0 (density softplus(0)) so that one SGD step of rate -1 from
    it gives the JAX step's gradient exactly: 0 + g."""
    (jmed, jcam, jprm), (med, cam, prm), _, _ = scene(W, H)
    jprm = dataclasses.replace(jprm, max_iters=96)
    prm = dataclasses.replace(prm, max_iters=96)
    rho = np.asarray(jmed.density.data)
    jbase = JMedium.from_grids(j_dense(rho), pack=False)
    base = medium_from_numpy(jbase.density, device="cpu", pack=False)
    ys, xs = np.mgrid[0:H, 0:W]
    raster = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)
    pids = np.arange(W * H, dtype=np.int32)
    target = np.zeros((W * H, 3), np.float32)
    return (jbase, jcam, jprm), (base, cam, prm), raster, pids, target


def port_step(mesh, base, cam, prm, raster, pids, target):
    """One port train step from log density 0; returns (loss, gradient)."""
    grids = tinv.OptimizableGrids(torch.zeros(base.density.shape, requires_grad=True))
    opt = torch.optim.SGD(tinv.grid_leaves(grids), lr=0.1)
    step = tinv.make_train_step(base, prm, cam, None, n_iters=64, mesh=mesh, samples_per_step=1)
    grids, opt, loss = step(grids, opt, torch.from_numpy(raster), torch.from_numpy(pids),
                            torch.from_numpy(target), (3, 1))
    return float(loss), grids.log_density.grad.numpy()
