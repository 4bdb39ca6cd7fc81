"""The dense arm's arithmetic in the port, on the CPU: world -> index and the
arrays the dense kernels read (csrc/trace_lanes.cu dense_trilinear).

- DenseGrid.world_to_index is a true float32 division, bitwise the JAX
  package's and numpy's, at voxel sizes that are not powers of two and at a
  world offset that is not one either; it and the temperature grid's own
  transform (integrator.temperature_local) divide by a tensor on the
  points' device, never by a host scalar (torch's CUDA division by a host
  scalar multiplies by the reciprocal, which the kernels do not).
- A medium without the fused table, from Medium.from_grids or
  medium_with_params, hands the kernels its grids' own arrays
  (megakernel.dense_arrays): no copy, on a CUDA device as on the CPU, and
  after an in-place update of the leaves (an Adam step) the next rebuilt
  medium reads the updated values. An array the kernels cannot read (not
  contiguous float32, or not of its grid's shape) is refused before a
  launch.
- The kernels' own-array fetch (each corner tested, read at flat index
  (cx * Y + cy) * Z + cz only where inside) gives exactly the packed
  table's corner rows for every base voxel in [-1, N-1]^3, the aligned
  temperature's 16-wide fused columns too, reads nothing for base voxels
  outside, and its sum is bitwise the port's and the JAX package's
  sample_trilinear_rows. The chip's bitwise dense-against-packed films hold
  the kernel itself.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from volume_path_tracer_tpu.grids import grid as jgrid
from volume_path_tracer_tpu_torch.diff import inverse as tinv
from volume_path_tracer_tpu_torch.grids import grid as tgrid
from volume_path_tracer_tpu_torch.grids import procedural as tproc
from volume_path_tracer_tpu_torch.models import medium as tmed
from volume_path_tracer_tpu_torch.render import integrator as tint
from volume_path_tracer_tpu_torch.render import megakernel as tmk

torch.set_num_threads(2)


@pytest.mark.parametrize("voxel,offset", [
    (0.1, (0.0, 0.0, 0.0)),
    (0.3, (0.0, 0.0, 0.0)),
    (1.0, (0.0, 0.0, 0.0)),
    (0.1, (-3.7, 1.3, 0.45)),
])
def test_world_to_index_is_a_true_division(voxel, offset):
    rng = np.random.default_rng(11)
    p = rng.uniform(-50.0, 50.0, (4096, 3)).astype(np.float32)
    data = np.zeros((2, 3, 4), np.float32)
    got = tgrid.dense_grid_from_array(data, (0, 0, 0), voxel, offset).world_to_index(torch.from_numpy(p)).numpy()
    jax_idx = np.asarray(jgrid.dense_grid_from_array(data, (0, 0, 0), voxel, offset).world_to_index(jnp.asarray(p)))
    want = (p - np.asarray(offset, np.float32)) / np.float32(voxel)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_idx)


class _Divisions(TorchDispatchMode):
    """Records the divisor of every aten division."""

    def __init__(self):
        super().__init__()
        self.divisors = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.div:
            self.divisors.append(args[1])
        return func(*args, **(kwargs or {}))


def _emissive_medium(t_voxel=0.3, t_offset=(-0.7, 0.2, 1.1)):
    dens = tgrid.dense_grid_from_array(np.ones((3, 4, 5), np.float32), (-1, 0, -2), 0.1, (1.0, 2.0, 3.0))
    temp = tgrid.dense_grid_from_array(np.ones((4, 3, 2), np.float32), (2, -1, 0), t_voxel, t_offset)
    return tmed.Medium.from_grids(dens, temp, pack=False, device="cpu")


@pytest.mark.parametrize("transform", ["world_to_index", "temperature_local"])
def test_world_to_index_divides_by_a_tensor_on_the_points_device(transform):
    med = _emissive_medium()
    p = torch.from_numpy(np.random.default_rng(4).uniform(-9.0, 9.0, (64, 3)).astype(np.float32))
    with _Divisions() as rec:
        if transform == "world_to_index":
            got = med.density.world_to_index(p)
        else:
            got = tint.temperature_local(med, p)
    assert len(rec.divisors) == 1
    d = rec.divisors[0]
    grid = med.density if transform == "world_to_index" else med.temperature
    assert isinstance(d, torch.Tensor) and d.device == p.device and d.dtype == torch.float32
    assert float(d) == np.float32(grid.voxel_size)
    if transform == "temperature_local":
        # the kernels' temperature_local: index -> world by the density
        # grid's transform, world -> index by the temperature grid's
        dg, tg = med.density, med.temperature
        pw = p.numpy() * np.float32(dg.voxel_size) + np.asarray(dg.world_offset, np.float32)
        want = (pw - np.asarray(tg.world_offset, np.float32)) / np.float32(tg.voxel_size) \
            - np.asarray(tg.origin_ijk, np.float32)
        np.testing.assert_array_equal(got.numpy(), want)


class _Props:
    L2_cache_size = 50 * 2**20  # an H100's


@pytest.fixture
def card_like(monkeypatch):
    """Grids that report a card with an H100's L2, so that an array choice
    keyed on the device or its cache would show here."""
    monkeypatch.setattr(tgrid.DenseGrid, "device", property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: _Props)


def _grids(scene):
    if scene == "fog_sphere":
        return (tproc.fog_sphere(radius=4.0, falloff=1.0),)
    return tproc.fire_plume(height=12, radius=3.0)


def _leaves(base, joint):
    return tinv.OptimizableGrids(tinv.param_from_density(base.density.data).requires_grad_(True),
                                 base.temperature.data.clone().requires_grad_(True) if joint else None)


@pytest.mark.parametrize("scene", ["fog_sphere", "fire_plume"])
@pytest.mark.parametrize("build", ["from_grids", "medium_with_params"])
def test_unpacked_media_hand_the_kernels_their_own_arrays(build, scene, card_like):
    grids = _grids(scene)
    base = tmed.Medium.from_grids(*grids, pack=False, device="cpu")
    if build == "from_grids":
        med, own = base, [g.data for g in grids]  # the grids' arrays themselves
    else:  # softplus of the log-density, and the temperature leaf itself
        leaves = _leaves(base, base.has_temperature)
        med = tinv.medium_with_params(base, leaves)
        own = [med.density.data] + ([leaves.temperature] if base.has_temperature else [])
    arrays = [a for a in tmk.dense_arrays(med, med.has_temperature) if a is not None]
    assert len(arrays) == len(own) == len(grids)
    for a, o in zip(arrays, own):
        assert a.data_ptr() == o.data_ptr() and a.dtype == torch.float32 and a.is_contiguous()
    assert tuple(arrays[0].shape) == med.density.shape


@pytest.mark.parametrize("leaves", ["density", "joint"])
def test_rebuilt_medium_reads_the_updated_leaves(leaves, card_like):
    joint = leaves == "joint"
    base = tmed.Medium.from_grids(*_grids("fire_plume" if joint else "fog_sphere"), pack=False, device="cpu")
    grids = _leaves(base, joint)
    opt = tinv.make_optimizer(grids, lr=0.05)
    before = [a.clone() for a in tmk.dense_arrays(tinv.medium_with_params(base, grids), joint) if a is not None]
    for p in tinv.grid_leaves(grids):
        p.grad = torch.ones_like(p)
    opt.step()  # in place, as a train step's update
    dd, td = tmk.dense_arrays(tinv.medium_with_params(base, grids), joint)
    assert torch.equal(dd, tinv.density_from_param(grids.log_density))
    assert not torch.equal(dd, before[0])
    if joint:
        assert td is grids.temperature and not torch.equal(td, before[1])


@pytest.mark.parametrize("bad", ["strided", "float64", "wrong_shape"])
def test_dense_array_the_kernel_cannot_read_is_refused(bad):
    shape = (4, 5, 6)
    data = torch.zeros(shape, dtype=torch.float64 if bad == "float64" else torch.float32)
    if bad == "strided":
        data = data.transpose(0, 2)
    if bad == "wrong_shape":  # the grid zero-padded by one voxel
        data = torch.zeros(tuple(n + 2 for n in shape))
    with pytest.raises(ValueError, match="has shape" if bad == "wrong_shape" else "contiguous float32"):
        tmk._check_dense(data, shape, "the density array", data.device)
    tmk._check_dense(torch.zeros(shape), shape, "the density array", torch.device("cpu"))


_OFFS = np.array(list(itertools.product((0, 1), repeat=3)), np.int64)  # corner order, z fastest


def _own_corners(data: np.ndarray, i0: np.ndarray):
    """csrc/trace_lanes.cu dense_trilinear's corners of base voxels i0 [M, 3]
    in the array `data` [X, Y, Z], emulated: corner c at i0 + (c >> 2,
    (c >> 1) & 1, c & 1), read at flat index (cx * Y + cy) * Z + cz where it
    is inside, else 0. Returns the corners [M, 8] and the flat indices read."""
    X, Y, Z = data.shape
    c = i0[:, None, :] + _OFFS[None]
    inside = ((c >= 0) & (c < np.array([X, Y, Z]))).all(-1)
    read = ((c[..., 0] * Y + c[..., 1]) * Z + c[..., 2])[inside]
    v = np.zeros(inside.shape, np.float32)
    v[inside] = data.reshape(-1)[read]
    return v, read


@pytest.mark.parametrize("scene", ["fog_sphere", "fire_plume", "fire_plume_aligned"])
def test_own_fetch_gives_the_packed_corners(scene):
    grids = _grids("fire_plume" if scene.startswith("fire") else scene)
    if scene == "fire_plume_aligned":  # the temperature in the density's frame
        dens, temp = grids
        grids = (dens, tgrid.dense_grid_from_array(temp.data, temp.origin_ijk, temp.voxel_size, (0.0, 0.0, 0.0)))
    rng = np.random.default_rng(5)
    for grid in grids:
        data = grid.data.numpy()
        shape = data.shape
        rows = tgrid.pack_corner_rows(grid.data).numpy()
        # every base voxel in [-1, N-1]^3, in the table's row order
        base = np.stack(np.meshgrid(*(np.arange(-1, n) for n in shape), indexing="ij"), -1).reshape(-1, 3)
        v, read = _own_corners(data, base)
        assert ((read >= 0) & (read < data.size)).all()
        np.testing.assert_array_equal(v, rows)
        # base voxels outside have no corner inside: nothing read, a 0 sum
        X, Y, Z = shape
        outside = np.array([(-2, 3, 4), (X, 3, 4), (2, -9, 4), (2, Y, 4), (2, 3, -2), (2, 3, Z), (-7, 40, 100)])
        v, read = _own_corners(data, outside)
        assert read.size == 0 and not v.any()
        # the kernel's sum, bitwise the packed sample, at base voxels near
        # both faces (-1, 0 and N-2, N-1) and in the middle
        jrows = jnp.asarray(rows)
        for i0 in itertools.product(*[(-1, 0, n // 2, n - 2, n - 1) for n in shape]):
            p = (np.array(i0, np.float32) + rng.uniform(0.0, 1.0, 3).astype(np.float32)).astype(np.float32)
            i0 = np.floor(p).astype(np.int64)
            w = tgrid.trilinear_weights(torch.from_numpy((p - i0.astype(np.float32)).astype(np.float32))).numpy()
            v = _own_corners(data, i0[None])[0][0]
            s = np.float32(v[0] * w[0])
            for c in range(1, 8):
                s = np.float32(s + v[c] * w[c])
            assert s == tgrid.sample_trilinear_rows(torch.from_numpy(rows), shape, torch.from_numpy(p)).item()
            assert s == np.asarray(jgrid.sample_trilinear_rows(jrows, shape, jnp.asarray(p)))
    if scene == "fire_plume_aligned":
        # the emission arm's own-array reads of an aligned temperature (here
        # the density's frame, offset 0) are the 16-wide fused rows' columns
        # 8..15
        dens, temp = grids
        fused = tmed.Medium.from_grids(dens, temp, pack=True, device="cpu").density_rows.numpy()
        assert fused.shape[1] == 16 and temp.shape == dens.shape and temp.origin_ijk == dens.origin_ijk
        np.testing.assert_array_equal(_own_corners(temp.data.numpy(), base)[0], fused[:base.shape[0], 8:])
