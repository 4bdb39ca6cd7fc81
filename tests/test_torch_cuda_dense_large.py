"""A dense medium of more than 2^31 voxels on the card: the forward kernels
read it, the gradient launches refuse it.

Runs only where CUDA is; elsewhere every test skips (on the card:
`python -m pytest --noconftest tests/test_torch_cuda_*.py`). This file
imports neither JAX nor the JAX package: the port's plain versions
(render_wave_plain, integrator.trace_rays), run on the same card, are the
reference.

The grid is 1300^3 (2,197,000,000 voxels, 8.8 GB) and empty but for a blob
at x >= 1282. A brick's majorant takes its one-voxel halo, so the bricks
and superbricks before x = 1280 hold majorant 0 and no lane samples the
density there: every sample's base voxel lies at x >= 1280, whose flat
offset (x * 1300 + y) * 1300 + z passes 2^31 (1272 * 1300^2 does). A
32-bit offset would wrap to another voxel or outside the array.

- render_wave on 65,536 lanes aimed at the blob (256 x 256 pixels), one
  launch of render_wave_kernel's dense instantiation, against
  render_wave_plain on the same card: the statistic of the repository's
  parity tests (more than 95% of lanes close at rtol 1e-4, atol 1e-5;
  channel means within 5%), and the blob's lanes carry radiance;
- trace_rays_fused (trace_lanes_kernel, dense) on 8,192 of those rays
  against integrator.trace_rays, by the same statistic;
- record_lanes at that size is refused before any launch, with the message
  of megakernel._check_dense.
"""
import numpy as np
import pytest
import torch

from volume_path_tracer_tpu_torch.grids.grid import dense_grid_from_array
from volume_path_tracer_tpu_torch.models.camera import Camera
from volume_path_tracer_tpu_torch.models.medium import Medium
from volume_path_tracer_tpu_torch.render import integrator as tint
from volume_path_tracer_tpu_torch.render import megakernel as tmk
from volume_path_tracer_tpu_torch.utils import rng as trng
from volume_path_tracer_tpu_torch.utils.config import CameraParameters

pytestmark = pytest.mark.cuda

N = 1300
CENTER = (1290.5, 650.0, 650.0)
RADIUS = 8.0
PIXELS = 256
PARAMS = tint.IntegratorParams(
    sigma_a=0.05, sigma_s=0.4, hg_g=0.4, le_scale=0.0, temperature_offset=300.0, temperature_scale=40.0,
    infinite_xyz=(0.25, 0.25, 0.5), infinite_multiplier=2.0, distant_xyz=(0.95, 1.0, 1.09),
    distant_multiplier=5.0, distant_inv_direction=(0.5, 1.0, 0.0), max_depth=100, max_iters=4096,
)


@pytest.fixture(scope="module")
def big():
    """(medium, camera) on the card; the grid is freed with the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    data = torch.zeros((N, N, N), dtype=torch.float32, device=dev)
    lo = [int(c - RADIUS) - 1 for c in CENTER]
    hi = [int(c + RADIUS) + 2 for c in CENTER]
    axes = [torch.arange(a, b, dtype=torch.float32, device=dev) - c for a, b, c in zip(lo, hi, CENTER)]
    x, y, z = torch.meshgrid(*axes, indexing="ij")
    blob = torch.clamp((RADIUS - torch.sqrt(x * x + y * y + z * z)) / 2.0, 0.0, 1.0)
    data[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = blob
    nz = data[:, 640:661, 640:661].sum(dim=(1, 2)).nonzero()
    assert int(nz.min()) >= 1282 and int(nz.max()) <= N - 1
    medium = Medium.from_grids(dense_grid_from_array(data), pack=False, device=dev)
    del data
    assert medium.form == "dense" and medium.density.data.numel() == 2_197_000_000
    # no majorant before x = 1280: no sample reads a voxel whose offset fits 31 bits
    assert float(medium.majorants.brick_maj[:160].max()) == 0.0 and float(medium.majorants.brick_maj[160:].max()) > 0
    cam = Camera.from_parameters(CameraParameters((1345.0, 652.0, 651.0), CENTER, (0.0, 1.0, 0.0), 22.0, 0.1),
                                 (PIXELS, PIXELS), device=dev)
    yield medium, cam
    del medium
    torch.cuda.empty_cache()


def _statistic(L, ref):
    L, ref = L.cpu().numpy(), ref.cpu().numpy()
    close = np.isclose(L, ref, rtol=1e-4, atol=1e-5).all(-1).mean()
    assert close > 0.95, close
    rel = np.abs(L.mean(0) - ref.mean(0)) / (np.abs(ref.mean(0)) + 1e-9)
    assert (rel < 0.05).all(), rel


def test_render_wave_reads_a_dense_grid_past_2_to_31_voxels(big):
    medium, cam = big
    dev = medium.device
    stream = trng.mix_stream(11, 3)
    film = torch.zeros((PIXELS, PIXELS, 4), dtype=torch.float32, device=dev)
    launches, dense = tmk.WAVE_LAUNCHES, tmk.DENSE_WAVE_LAUNCHES
    _, n_capped = tmk.render_wave(medium, PARAMS, cam, None, film, range(PIXELS * PIXELS), stream, True, 0.1)
    torch.cuda.synchronize(dev)
    assert (tmk.WAVE_LAUNCHES, tmk.DENSE_WAVE_LAUNCHES) == (launches + 1, dense + 1)
    plain = torch.zeros_like(film)
    _, n_capped_plain = tmk.render_wave_plain(medium, PARAMS, cam, None, plain, range(PIXELS * PIXELS), stream,
                                              True, 0.1)
    assert int(n_capped) == int(n_capped_plain) == 0
    got, want = film.reshape(-1, 4), plain.reshape(-1, 4)
    assert torch.equal(got[:, 3], torch.ones_like(got[:, 3]))
    _statistic(got[:, :3], want[:, :3])
    # the blob's lanes carry radiance, and it differs from the background's
    # (a lane that misses the blob sees only the infinite light)
    c = PIXELS // 2
    centre = got.reshape(PIXELS, PIXELS, 4)[c - 8:c + 8, c - 8:c + 8, :3]
    corner = got.reshape(PIXELS, PIXELS, 4)[:8, :8, :3]
    assert float(centre.sum()) > 0
    assert not torch.allclose(centre.mean(dim=(0, 1)), corner.mean(dim=(0, 1)), rtol=0.05)


def test_trace_lanes_reads_a_dense_grid_past_2_to_31_voxels(big):
    medium, cam = big
    dev = medium.device
    pids = torch.arange(0, PIXELS * PIXELS, 8, dtype=torch.int64, device=dev)
    raster = torch.stack([pids % PIXELS, pids // PIXELS], -1)
    o, d = cam.generate_rays(raster, torch.zeros((pids.shape[0], 2), device=dev))
    stream = trng.mix_stream(12, 1)
    dense = tmk.DENSE_LAUNCHES
    L, _, nc = tmk.trace_rays_fused(medium, PARAMS, None, o, d, pids, stream)
    assert tmk.DENSE_LAUNCHES == dense + 1
    L_p, _, nc_p = tint.trace_rays(medium, PARAMS, None, o, d, pids, stream)
    assert int(nc) == int(nc_p) == 0
    assert float(L.sum()) > 0
    _statistic(L, L_p)


def test_a_record_launch_at_that_size_is_refused(big):
    medium, cam = big
    dev = medium.device
    pids = torch.arange(1024, dtype=torch.int64, device=dev)
    raster = torch.stack([pids % PIXELS, pids // PIXELS], -1)
    o, d = cam.generate_rays(raster, torch.zeros((1024, 2), device=dev))
    records = tmk.RECORD_LAUNCHES
    with pytest.raises(ValueError, match="a gradient launch takes dense arrays of fewer than 2\\^31 voxels"):
        tmk.record_lanes(medium, PARAMS, None, o, d, pids, trng.mix_stream(13, 1), 4)
    assert tmk.RECORD_LAUNCHES == records
