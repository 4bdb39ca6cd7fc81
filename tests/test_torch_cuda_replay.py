"""replay_lanes on the card: the replay kernel's gradient grids against the
plain replay.

Runs only where CUDA is; elsewhere every test skips (on the card:
`python -m pytest --noconftest tests/test_torch_cuda_*.py`). This file
imports neither JAX nor the JAX package: the plain replay (replay_lanes_plain,
diff/prb.py replay_grads, which scatters into corner-row tables and folds
them), run on the same card, is the reference; tests/test_torch_prb.py holds
it to the JAX package on the CPU.

The kernel adds each event's 8 weighted corners straight into [X, Y, Z]
gradient grids with float atomics and drops the corners outside the grid,
so there is no corner-row table and no fold on the card:

- on a scattering density-only medium and on an emissive one whose
  temperature grid has its own transform and shape, packed and dense (the
  grids' own arrays), the kernel's grids equal the plain replay's within
  relative L2 1e-5 on the lanes where the record agrees (the atomics sum in
  another order);
- on a density that fills its box, so that base voxels -1 and dim - 1 take
  gradient, the grids agree on the boundary shell too: a corner outside the
  grid is dropped, not wrapped into a neighbouring row;
- the grids have the medium's shapes, a call is one replay launch and no
  plain run, and an eager train step on the card enters no prb.fold span.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from volume_path_tracer_tpu_torch.diff import inverse as inv
from volume_path_tracer_tpu_torch.grids.grid import dense_grid_from_array
from volume_path_tracer_tpu_torch.grids.procedural import fire_plume, fog_sphere
from volume_path_tracer_tpu_torch.models.camera import Camera
from volume_path_tracer_tpu_torch.models.medium import Medium
from volume_path_tracer_tpu_torch.render import megakernel as tmk
from volume_path_tracer_tpu_torch.render.integrator import IntegratorParams
from volume_path_tracer_tpu_torch.utils import rng as trng
from volume_path_tracer_tpu_torch.utils import spans
from volume_path_tracer_tpu_torch.utils.config import CameraParameters
from volume_path_tracer_tpu_torch.utils.spectral import blackbody_xyz_table

pytestmark = pytest.mark.cuda

N = 2048
K = 16
SCATTER = IntegratorParams(
    sigma_a=0.1, sigma_s=0.6, hg_g=0.4, le_scale=0.0, temperature_offset=300.0, temperature_scale=40.0,
    infinite_xyz=(1.0, 1.0, 1.0), infinite_multiplier=0.3, distant_xyz=(0.95, 1.0, 1.09),
    distant_multiplier=5.0, distant_inv_direction=(0.3, 0.8, 0.2), max_depth=40, max_iters=256,
)
FIRE = IntegratorParams(
    sigma_a=2.0, sigma_s=0.9, hg_g=0.7, le_scale=4e-8, temperature_offset=300.0, temperature_scale=43.0,
    infinite_xyz=(0.25, 0.25, 0.5), infinite_multiplier=10.0, distant_xyz=(0.95047, 1.0, 1.08883),
    distant_multiplier=20.0, distant_inv_direction=(0.5, 1.0, 0.0), max_depth=1_000_000, max_iters=512,
)
FORMS = ["packed", "own"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _box_grid():
    """A 12 x 10 x 9 density that fills its box: every boundary voxel dense."""
    rng = np.random.default_rng(3)
    return dense_grid_from_array((0.4 * (0.75 + 0.5 * rng.random((12, 10, 9)))).astype(np.float32))


def _fire_grids():
    """The plume's density, and its temperature cropped to another shape
    (still hot on the cropped faces) under another origin and world offset."""
    dens, temp = fire_plume(height=24, radius=6.0)
    t = temp.data[3:-3, 2:-4, 4:-2]
    o = temp.origin_ijk
    own = dense_grid_from_array(t.contiguous(), (o[0] + 3, o[1] + 2, o[2] + 4), temp.voxel_size, (0.3, -0.2, 0.45))
    assert own.shape != dens.shape and float(own.data[0].abs().max()) > 0
    return dens, own


def _medium(grids, form, dev):
    """The medium a train step builds (medium_with_params) in `form`."""
    base = Medium.from_grids(*grids, pack=False, device=dev)
    leaves = inv.OptimizableGrids(inv.param_from_density(base.density.data),
                                  base.temperature.data if base.temperature is not None else None)
    med = inv.medium_with_params(base, leaves, pack=form == "packed")
    assert (med.density_rows is None) == (form == "own")
    return med


def _rays(med, dev, seed=0):
    """N world rays from a sphere around the density's box, each aimed at a
    point inside it, so rays enter through every face."""
    g = med.density
    lo = np.asarray(g.world_offset) + np.asarray(g.origin_ijk) * g.voxel_size
    size = np.asarray(g.shape) * g.voxel_size
    rng = np.random.default_rng(seed)
    aim = lo + rng.random((N, 3)) * size
    v = rng.normal(size=(N, 3))
    o = lo + size / 2 + 2.0 * np.linalg.norm(size) * v / np.linalg.norm(v, axis=1, keepdims=True)
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    as_t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return as_t(o), as_t(d), torch.arange(N, dtype=torch.int32, device=dev), trng.mix_stream(3, 1)


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _shell(x):
    """The voxels on the grid's six faces."""
    m = torch.ones_like(x, dtype=torch.bool)
    m[1:-1, 1:-1, 1:-1] = False
    return x[m]


def _replay_both(med, prm, bb, dev):
    """(kernel grids, plain grids): the record kernel's and the plain
    record's outputs, the cotangent on the lanes where they agree, then
    replay_lanes (one launch, longest_first order) and replay_lanes_plain on
    the same card."""
    rays = _rays(med, dev)
    L_k, tf_k, ctr_k = tmk.record_lanes(med, prm, bb, *rays, K)
    L_p, tf_p, _ = tmk.record_lanes_plain(med, prm, bb, *rays, K)
    agree = torch.isclose(L_k, L_p, rtol=1e-4, atol=1e-5).all(-1)
    assert float(agree.float().mean()) > 0.95
    g = torch.tensor(np.random.default_rng(1).uniform(0.2, 1.0, (N, 3)), dtype=torch.float32, device=dev)
    g = g * agree[:, None]
    launches, plain = tmk.REPLAY_LAUNCHES, tmk.PLAIN_REPLAY_LAUNCHES
    got = tmk.replay_lanes(med, prm, bb, *rays, L_k, g, tf=tf_k, order=tmk.longest_first(ctr_k))
    assert (tmk.REPLAY_LAUNCHES, tmk.PLAIN_REPLAY_LAUNCHES) == (launches + 1, plain)
    want = tmk.replay_lanes_plain(med, prm, bb, *rays, L_p, g, tf=tf_p)
    return got, want


@pytest.mark.parametrize("form", FORMS)
def test_density_only_scattering(dev, form):
    med = _medium((fog_sphere(radius=8.0, falloff=2.0),), form, dev)
    (dk, tk), (dp, tp) = _replay_both(med, SCATTER, None, dev)
    assert tk is None and tp is None
    assert dk.shape == med.density.shape and dk.dtype == torch.float32 and dk.device == dev
    assert float(dp.abs().max()) > 0
    assert rel_l2(dk, dp) <= 1e-5


@pytest.mark.parametrize("form", FORMS)
def test_emissive_temperature_with_its_own_transform_and_shape(dev, form):
    med = _medium(_fire_grids(), form, dev)
    bb = torch.from_numpy(blackbody_xyz_table()).to(dev)
    (dk, tk), (dp, tp) = _replay_both(med, FIRE, bb, dev)
    assert dk.shape == med.density.shape and tk.shape == med.temperature.shape
    assert tk.shape != dk.shape and tk.dtype == torch.float32
    assert float(dp.abs().max()) > 0 and float(tp.abs().max()) > 0
    assert rel_l2(dk, dp) <= 1e-5
    assert rel_l2(tk, tp) <= 1e-5
    # the temperature's cropped faces take gradient, and agree there
    assert float(_shell(tp).abs().max()) > 0
    assert rel_l2(_shell(tk), _shell(tp)) <= 1e-5


@pytest.mark.parametrize("form", FORMS)
def test_boundary_voxels_drop_outside_corners(dev, form):
    med = _medium((_box_grid(),), form, dev)
    (dk, _), (dp, _) = _replay_both(med, SCATTER, None, dev)
    assert dk.shape == med.density.shape
    for axis in range(3):
        for end in (0, -1):
            face_k, face_p = dk.select(axis, end), dp.select(axis, end)
            assert bool((face_p != 0).any()), (axis, end)
            assert rel_l2(face_k, face_p) <= 1e-5, (axis, end)
    assert rel_l2(dk, dp) <= 1e-5
    # nothing lands outside the grid: the sums agree as the grids do
    assert abs(float(dk.double().sum() - dp.double().sum())) <= 1e-5 * float(dp.double().abs().sum())


def test_train_step_on_the_card_has_no_fold(dev):
    """One eager train step under a profile (a fresh Adam: the step runs as
    a CUDA graph only once Adam has its state, and the graph's body is this
    step's, tests/test_torch_cuda_train_graph.py): the replay span is there,
    the fold's is not, and the backward is one replay launch."""
    W = H = 16
    base = Medium.from_grids(fog_sphere(radius=6.0, falloff=2.0), pack=False, device=dev)
    cam = Camera.from_parameters(CameraParameters((24.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 38.0, 0.5),
                                 (W, H), device=dev)
    ys, xs = np.mgrid[0:H, 0:W]
    raster = torch.from_numpy(np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)).to(dev)
    pids = torch.arange(W * H, dtype=torch.int32, device=dev)
    grids = inv.OptimizableGrids(inv.param_from_density(base.density.data).requires_grad_(True))
    opt = inv.make_optimizer(grids)
    step = inv.make_train_step(base, SCATTER, cam, None, n_iters=64, samples_per_step=2)
    target = torch.zeros((W * H, 3), device=dev)
    step(grids, inv.make_optimizer(grids), raster, pids, target, (3, 1))  # warm-up, with an Adam of its own
    torch.cuda.synchronize(dev)
    launches, plain = tmk.REPLAY_LAUNCHES, tmk.PLAIN_REPLAY_LAUNCHES
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(grids, opt, raster, pids, target, (3, 2))
        torch.cuda.synchronize(dev)
    names = [e.name for e in prof.events() if e.name in spans.SPANS]
    assert "prb.replay" in names and "prb.fold" not in names
    assert (tmk.REPLAY_LAUNCHES, tmk.PLAIN_REPLAY_LAUNCHES) == (launches + 1, plain)
    assert grids.log_density.grad.shape == base.density.shape
