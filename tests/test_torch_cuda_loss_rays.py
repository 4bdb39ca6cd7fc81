"""loss_rays on the card: loss_rays_kernel against the plain version.

Runs only where CUDA is; elsewhere every test skips (on the card:
`python -m pytest tests/test_torch_cuda_*.py`). This file imports neither
JAX nor the JAX package: the plain version, run on the same card, is the
reference (tests/test_torch_inverse.py holds it to the JAX package on the
CPU).

- The kernel branch of loss_rays against loss_rays_plain on the same card:
  pixel ids, stream words and jitter uniforms bitwise, directions within
  1e-6 (the product's rounding order differs), origins the camera's
  position expanded; one kernel launch a call and no plain run.
- loss_rays waits for nothing: under torch.cuda.set_sync_debug_mode
  ("error") a call raises nothing.
"""
import numpy as np
import pytest
import torch

from volume_path_tracer_tpu_torch.models.camera import Camera
from volume_path_tracer_tpu_torch.render import megakernel as tmk
from volume_path_tracer_tpu_torch.utils import rng as trng
from volume_path_tracer_tpu_torch.utils.config import CameraParameters

pytestmark = pytest.mark.cuda

W, H = 40, 24
SEED = 0xDEADBEEF
# (k, wave0): waves wave0 * k + i that wrap past 2^32 for every i (k = 4),
# for some (k = 3), and the largest wave (k = 1).
CASES = [(1, 2**32 - 1), (3, 1431655765), (4, 2**30 + 3)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _inputs(dev, pid_dtype, raster_dtype=torch.int32):
    cam = Camera.from_parameters(
        CameraParameters((20.0, 3.0, -4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 40.0, 0.1), (W, H), device=dev)
    ys, xs = np.mgrid[0:H, 0:W]
    raster = torch.from_numpy(np.stack([xs.reshape(-1), ys.reshape(-1)], -1)).to(dev)
    # A batch in no particular order, as a shard or a sample of pixels may be.
    perm = torch.from_numpy(np.random.default_rng(5).permutation(W * H)).to(dev)
    pids = (raster[:, 1] * W + raster[:, 0])[perm].to(pid_dtype).contiguous()
    return cam, raster[perm].to(raster_dtype).contiguous(), pids


@pytest.mark.parametrize("raster_dtype", [torch.int32, torch.int64], ids=["raster32", "raster64"])
@pytest.mark.parametrize("pid_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("use_jitter", [True, False], ids=["jitter", "no_jitter"])
@pytest.mark.parametrize("k,wave0", CASES, ids=["k1", "k3_wraps_partly", "k4_wraps"])
def test_kernel_matches_plain_on_the_card(dev, k, wave0, use_jitter, pid_dtype, raster_dtype):
    cam, raster, pids = _inputs(dev, pid_dtype, raster_dtype)
    n = pids.shape[0]
    jit = torch.full((k * n, 2), -1.0, dtype=torch.float32, device=dev)
    launches, plain = tmk.LOSS_RAYS_LAUNCHES, tmk.PLAIN_LOSS_RAYS_LAUNCHES
    o, d, p, s = tmk.loss_rays(cam, raster, pids, (SEED, wave0), k, use_jitter, jitter_out=jit)
    assert (tmk.LOSS_RAYS_LAUNCHES, tmk.PLAIN_LOSS_RAYS_LAUNCHES) == (launches + 1, plain)
    ro, rd, rp, rs = tmk.loss_rays_plain(cam, raster, pids, (SEED, wave0), k, use_jitter)
    assert p.dtype == pid_dtype and torch.equal(p, rp)
    assert s.dtype == torch.int32 and torch.equal(s.to(torch.int64) & 0xFFFFFFFF, rs)
    u = trng.counter_uniforms(rp, rs, tmk.JITTER_COUNTER, 2)
    assert torch.equal(jit.view(torch.int32), u.view(torch.int32))
    assert o.stride() == (0, 1) and torch.equal(o, ro)
    assert d.shape == (k * n, 3) and float((d - rd).abs().max()) <= 1e-6


def test_loss_rays_does_not_sync(dev):
    """A call after a warm-up (the library built and loaded) under
    set_sync_debug_mode("error"): any wait for the card would raise."""
    cam, raster, pids = _inputs(dev, torch.int32)
    tmk.loss_rays(cam, raster, pids, (SEED, 7), 4, True)
    torch.cuda.synchronize(dev)
    launches = tmk.LOSS_RAYS_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tmk.loss_rays(cam, raster, pids, (SEED, 8), 4, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tmk.LOSS_RAYS_LAUNCHES == launches + 1
    torch.cuda.synchronize(dev)
    assert bool(torch.isfinite(out[1]).all())
