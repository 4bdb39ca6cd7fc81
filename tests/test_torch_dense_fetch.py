"""The dense arm's arithmetic in the port, on the CPU: world -> index and the
two forms of array the dense kernels read (csrc/trace_lanes.cu
dense_trilinear).

- DenseGrid.world_to_index is a true float32 division, bitwise the JAX
  package's and numpy's, at voxel sizes that are not powers of two and at a
  world offset that is not one either; it and the temperature grid's own
  transform (integrator.temperature_local) divide by a tensor on the
  points' device, never by a host scalar (torch's CUDA division by a host
  scalar multiplies by the reciprocal, which the kernels do not).
- A medium without the fused table keeps a copy of each array zero-padded
  by one voxel (DenseGrid.padded, grids/grid.py pad_voxels) only on a CUDA
  device whose L2 cache holds the copies (models/medium.py pads_in_l2);
  a new array (dataclasses.replace, another device) drops the copy; the
  wrapper passes the copies where every grid a launch reads has one, else
  the grids' own arrays (megakernel.dense_arrays).
- The padded fetch's addresses (the base voxel clamped into [-1, N-1] per
  axis, one base plus two strides, all 8 read) give, bitwise, the port's and
  the JAX package's gather_voxels corners and sample_trilinear_rows sample
  at base voxels on every face, edge and corner of an odd-shaped grid, and
  stay inside the padded array for base voxels outside the grid. The chip's
  bitwise dense-against-packed films hold the kernel itself.
"""
import dataclasses
import itertools
import types

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


def test_pad_voxels_is_numpy_pad():
    data = np.random.default_rng(3).uniform(0.1, 2.0, (5, 7, 9)).astype(np.float32)
    got = tgrid.pad_voxels(torch.from_numpy(data))
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.pad(data, 1))


@pytest.mark.parametrize("in_l2", [False, True], ids=["cpu", "fits_l2"])
@pytest.mark.parametrize("build", ["from_grids", "medium_with_params"])
def test_unpacked_media_carry_the_padded_arrays(build, in_l2, monkeypatch):
    if in_l2:  # what a CUDA device whose L2 holds the copies answers
        monkeypatch.setattr(tmed, "pads_in_l2", lambda device, shapes: True)
    dens, temp = tproc.fire_plume(height=12, radius=3.0)
    base = tmed.Medium.from_grids(dens, temp, pack=False, device="cpu")
    if build == "from_grids":
        med, packed = base, tmed.Medium.from_grids(dens, temp, pack=True, device="cpu")
    else:
        grids = tinv.OptimizableGrids(tinv.param_from_density(base.density.data).requires_grad_(True),
                                      base.temperature.data.clone().requires_grad_(True))
        med, packed = (tinv.medium_with_params(base, grids, pack=p) for p in (False, True))
    for grid in (med.density, med.temperature):
        if not in_l2:
            assert grid.padded is None
            continue
        assert not grid.padded.requires_grad and grid.padded.is_contiguous()
        np.testing.assert_array_equal(grid.padded.numpy(), np.pad(grid.data.detach().numpy(), 1))
    assert packed.density.padded is None and packed.temperature.padded is None
    dd, td = tmk.dense_arrays(med, True)
    assert (dd is med.density.padded and td is med.temperature.padded) if in_l2 else \
        (dd is med.density.data and td is med.temperature.data)


class _Props:
    L2_cache_size = 50 * 2**20  # an H100's


@pytest.mark.parametrize("device,shapes,fits", [
    ("cuda", [(77, 77, 77)], True),  # the flagship's fog_sphere(30, 6)
    ("cuda", [(512, 512, 512)], False),  # big_cloud(512)
    ("cuda", [(200, 200, 200), (200, 200, 200)], False),  # each fits alone, not both
    ("cpu", [(4, 4, 4)], False),
])
def test_padded_copies_only_where_they_fit_in_l2(device, shapes, fits, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: _Props)
    assert tmed.pads_in_l2(torch.device(device, 0), shapes) == fits


@pytest.mark.parametrize("change", ["replace", "to", "detached"])
def test_a_new_array_drops_the_padded_copy(change):
    grid = tgrid.with_padded_copy(tproc.fog_sphere(radius=4.0, falloff=1.0))
    assert grid.padded is not None and tgrid.with_padded_copy(grid) is grid
    if change == "replace":
        assert dataclasses.replace(grid, data=grid.data * 2).padded is None
    elif change == "to":
        assert grid.to("cpu").padded is None
    else:  # the same values, detached (prb's medium for the kernels)
        assert grid.detached().padded is grid.padded


def test_dense_arrays_take_one_form_for_both_grids():
    med = _emissive_medium()
    half = dataclasses.replace(med, density=tgrid.with_padded_copy(med.density))
    # only the density has a copy: a launch that reads the temperature reads
    # both grids' own arrays, one that does not reads the density's copy
    dd, td = tmk.dense_arrays(half, True)
    assert dd is med.density.data and td is med.temperature.data
    dd, td = tmk.dense_arrays(half, False)
    assert dd is half.density.padded and td is None
    assert [n for _, n, _ in tmk.tap_layout(half, 0)][0] == -(-half.density.padded.numel() // 8)
    assert [n for _, n, _ in tmk.tap_layout(half, 3)][0] == -(-med.density.data.numel() // 8)
    # the PADDED_* counters count a launch by the same choice
    assert not tmk._reads_padded(half, types.SimpleNamespace(dense=True, emission=3))
    assert tmk._reads_padded(half, types.SimpleNamespace(dense=True, emission=0))
    assert not tmk._reads_padded(med, types.SimpleNamespace(dense=True, emission=0))


@pytest.mark.parametrize("bad", ["strided", "float64"])
def test_dense_array_the_kernel_cannot_read_is_refused(bad):
    data = torch.zeros((4, 5, 6), dtype=torch.float64 if bad == "float64" else torch.float32)
    if bad == "strided":
        data = data.transpose(0, 2)
    with pytest.raises(ValueError, match="contiguous float32"):
        tmk._check_dense(data, "the density array", data.device)
    tmk._check_dense(torch.zeros((4, 5, 6)), "the density array", torch.device("cpu"))


def test_padded_fetch_gives_the_packed_corners():
    shape = (5, 7, 9)
    X, Y, Z = shape
    rng = np.random.default_rng(5)
    data = rng.uniform(0.1, 2.0, shape).astype(np.float32)
    padded = tgrid.pad_voxels(torch.from_numpy(data)).numpy().reshape(-1)
    rows = tgrid.pack_corner_rows(torch.from_numpy(data))
    jrows = jnp.asarray(rows.numpy())
    sy, sx = Z + 2, (Y + 2) * (Z + 2)
    offs = np.array(list(itertools.product((0, 1), repeat=3)), np.int64)

    def addresses(i0):
        ix, iy, iz = (int(v) for v in i0)
        base = (np.clip(ix, -1, X - 1) + 1) * sx + (np.clip(iy, -1, Y - 1) + 1) * sy + np.clip(iz, -1, Z - 1) + 1
        return [int(base + o) for o in (0, 1, sy, sy + 1, sx, sx + 1, sx + sy, sx + sy + 1)]

    # base voxels per axis near both faces (-1, 0 and N-2, N-1: a base voxel
    # of -1 or N-1 has one corner outside) and in the middle
    axes = [(-1, 0, n // 2, n - 2, n - 1) for n in shape]
    for i0 in itertools.product(*axes):
        p = (np.array(i0, np.float32) + rng.uniform(0.0, 1.0, 3).astype(np.float32)).astype(np.float32)
        i0 = np.floor(p).astype(np.int64)
        f = (p - i0.astype(np.float32)).astype(np.float32)
        addr = addresses(i0)
        assert all(0 <= a < padded.size for a in addr)
        v = padded[addr]
        ijk = i0[None, :] + offs
        np.testing.assert_array_equal(v, tgrid.gather_voxels(torch.from_numpy(data), torch.from_numpy(ijk)).numpy())
        w = tgrid.trilinear_weights(torch.from_numpy(f)).numpy()
        s = np.float32(v[0] * w[0])
        for c in range(1, 8):
            s = np.float32(s + v[c] * w[c])
        assert s == tgrid.sample_trilinear_rows(rows, shape, torch.from_numpy(p)).item()
        assert s == np.asarray(jgrid.sample_trilinear_rows(jrows, shape, jnp.asarray(p)))
    # an invalid base voxel's addresses stay inside the padded array
    for i0 in [(-2, 3, 4), (5, 3, 4), (2, -9, 4), (2, 7, 4), (2, 3, -2), (2, 3, 9), (-7, 40, 100)]:
        assert all(0 <= a < padded.size for a in addresses(i0))
