"""The port's data and tables against the JAX package's.

Held bitwise: the strict scene config, procedural grids, the blackbody table
and pairs, corner rows, corner-row indices, majorants, fused rows (8- and
16-wide) and the temperature fold, on fog_sphere(12, 3), the misaligned
fire_plume(40, 10) and its aligned re-framing (tests/test_megakernel.py).
Camera rays hold to rtol=1e-6 (a float32 product and normalize whose
rounding order is XLA's on one side and torch's on the other).
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_path_tracer_tpu.grids import grid as jgrid
from volume_path_tracer_tpu.grids import majorant as jmaj
from volume_path_tracer_tpu.grids import procedural as jproc
from volume_path_tracer_tpu.models import medium as jmed
from volume_path_tracer_tpu.models.camera import Camera as JCamera
from volume_path_tracer_tpu.utils import color as jcolor
from volume_path_tracer_tpu.utils import config as jconfig
from volume_path_tracer_tpu.utils import spectral as jspec
from volume_path_tracer_tpu_torch.grids import grid as tgrid
from volume_path_tracer_tpu_torch.grids import majorant as tmaj
from volume_path_tracer_tpu_torch.grids import procedural as tproc
from volume_path_tracer_tpu_torch.models import medium as tmed
from volume_path_tracer_tpu_torch.models.camera import Camera as TCamera
from volume_path_tracer_tpu_torch.utils import color as tcolor
from volume_path_tracer_tpu_torch.utils import config as tconfig
from volume_path_tracer_tpu_torch.utils import spectral as tspec

torch.set_num_threads(2)

SCENE = {
    "worker_parameters": {
        "single_pixel": {"enabled": False, "coord": [3, 4]},
        "infinite_light": {"xyz": [4.382, 3.509, 17.603], "multiplier": 0.14},
        "distant_light": {"xyz": [0.95047, 1.0, 1.08883], "multiplier": 50.0,
                          "inv_direction": [0.5826, 0.7660, 0.2717]},
        "use_jitter": True,
        "max_depth": 100,
    },
    "volume_parameters": {
        "sigma_s": 0.15, "sigma_a": 0.0, "henyey_greenstein_g": 0.4,
        "le_scale": 0.0, "temperature_offset": 300.0, "temperature_scale": 40.0,
    },
    "seed": 10, "output_size": [1920, 1080], "tile_size": [16, 16],
    "num_waves": 128, "num_workers": 8, "volume_path": "wdas_cloud/wdas_cloud.nvdb",
    "camera_parameters": {"position": [-676.0, 154.0, -3.0], "look": [0.0, 69.0, 0.0],
                          "up": [0.0, 1.0, 0.0], "vfov_deg": 35, "imaging_ratio": 1.0},
}


def _eq(j, t):
    j = np.asarray(j)
    t = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return j.shape == t.shape and j.dtype == t.dtype and np.array_equal(
        j.view(np.uint8), t.view(np.uint8)
    )


def _grids(name):
    """(jax density, jax temperature or None, port density, port temperature or None)."""
    if name == "fog_sphere":
        return jproc.fog_sphere(12.0, 3.0), None, tproc.fog_sphere(12.0, 3.0), None
    jd, jt = jproc.fire_plume(height=40, radius=10.0)
    td, tt = tproc.fire_plume(height=40, radius=10.0)
    if name == "fire_plume_aligned":
        jt = jgrid.dense_grid_from_array(np.asarray(jt.data), jt.origin_ijk, jt.voxel_size, (0.0, 0.0, 0.0))
        tt = tgrid.dense_grid_from_array(tt.data, tt.origin_ijk, tt.voxel_size, (0.0, 0.0, 0.0))
    return jd, jt, td, tt


GRIDS = ["fog_sphere", "fire_plume", "fire_plume_aligned"]


# ---------------- config ----------------

def test_config_parses_like_jax():
    text = json.dumps(SCENE)
    j = jconfig.loads_configuration(text, base_dir="/scenes")
    t = tconfig.loads_configuration(text, base_dir="/scenes")
    assert dataclasses.astuple(j) == dataclasses.astuple(t)
    assert t.volume_path == "/scenes/wdas_cloud/wdas_cloud.nvdb"


@pytest.mark.parametrize("where,key", [((), "seed"), (("camera_parameters",), "vfov_deg"),
                                       (("worker_parameters", "distant_light"), "inv_direction")])
def test_config_missing_key_rejected(where, key):
    obj = json.loads(json.dumps(SCENE))
    node = obj
    for k in where:
        node = node[k]
    del node[key]
    with pytest.raises(tconfig.ConfigError, match=f"missing required key.*{key}"):
        tconfig.loads_configuration(json.dumps(obj))


def test_config_unknown_key_rejected():
    obj = json.loads(json.dumps(SCENE))
    obj["output_image"] = "x.png"
    with pytest.raises(tconfig.ConfigError, match="unknown key"):
        tconfig.loads_configuration(json.dumps(obj))
    obj = json.loads(json.dumps(SCENE))
    obj["worker_parameters"]["max_depth"] = 1.5
    with pytest.raises(tconfig.ConfigError, match="integer"):
        tconfig.loads_configuration(json.dumps(obj))


def test_read_configuration_resolves_relative_to_file(tmp_path):
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(SCENE))
    cfg = tconfig.read_configuration(str(p))
    assert cfg.volume_path == str(tmp_path / "wdas_cloud" / "wdas_cloud.nvdb")


# ---------------- spectral ----------------

@pytest.mark.parametrize("n", [500, 640])
def test_blackbody_table_and_pairs_bitwise(n):
    jt = jspec.blackbody_xyz_table(n)
    tt = tspec.blackbody_xyz_table(n)
    assert _eq(jt, tt)
    assert _eq(jspec.blackbody_pairs(jnp.asarray(jt)), tspec.blackbody_pairs(torch.from_numpy(tt)))


@pytest.mark.parametrize("t_max", [0.0, 1500.0, 49_900.0, 62_345.0])
def test_breakpoints_for_max_temp(t_max):
    assert tspec.breakpoints_for_max_temp(t_max) == jspec.breakpoints_for_max_temp(t_max)


def test_blackbody_lookup_from_pairs():
    table = tspec.blackbody_xyz_table()
    temps = np.concatenate([[-5.0, 0.0, 50.0, 49_899.5, 60_000.0],
                            np.random.default_rng(0).uniform(0, 12_000, 2000)]).astype(np.float32)
    j = np.asarray(jspec.blackbody_radiation_xyz_from_pairs(
        jspec.blackbody_pairs(jnp.asarray(table)), jnp.asarray(temps)))
    t = tspec.blackbody_radiation_xyz_from_pairs(
        tspec.blackbody_pairs(torch.from_numpy(table)), torch.from_numpy(temps)).numpy()
    # XLA may contract the lerp's multiply-add; torch rounds the product first.
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    assert (t[:2] == 0).all()


# ---------------- grids and tables ----------------

@pytest.mark.parametrize("name", GRIDS)
def test_procedural_grids_bitwise(name):
    jd, jt, td, tt = _grids(name)
    assert _eq(jd.data, td.data)
    assert (jd.origin_ijk, jd.voxel_size, jd.world_offset) == (td.origin_ijk, td.voxel_size, td.world_offset)
    if jt is not None:
        assert _eq(jt.data, tt.data)
        assert (jt.origin_ijk, jt.world_offset) == (tt.origin_ijk, tt.world_offset)


def test_donut_bitwise():
    assert _eq(jproc.generate_donut().data, tproc.generate_donut().data)


@pytest.mark.parametrize("name", GRIDS)
def test_pack_corner_rows_bitwise(name):
    jd, jt, td, tt = _grids(name)
    assert _eq(jgrid.pack_corner_rows(jd.data), tgrid.pack_corner_rows(td.data))
    if jt is not None:
        assert _eq(jgrid.pack_corner_rows(jt.data), tgrid.pack_corner_rows(tt.data))


def test_corner_row_index_bitwise():
    shape = (25, 40, 25)
    i0 = np.random.default_rng(5).integers(-4, 44, (5000, 3)).astype(np.int32)
    jb, jv = jgrid.corner_row_index(shape, jnp.asarray(i0))
    tb, tv = tgrid.corner_row_index(shape, torch.from_numpy(i0).to(torch.int64))
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())


def test_sample_trilinear_rows_matches_raw_gather():
    _, _, td, _ = _grids("fog_sphere")
    p = torch.from_numpy(np.random.default_rng(6).uniform(-3, 30, (4000, 3)).astype(np.float32))
    rows = tgrid.pack_corner_rows(td.data)
    np.testing.assert_array_equal(
        tgrid.sample_trilinear_rows(rows, td.shape, p).numpy(),
        tgrid.sample_trilinear_local(td.data, p).numpy(),
    )


@pytest.mark.parametrize("name", GRIDS)
def test_build_majorants_bitwise(name):
    jd, _, td, _ = _grids(name)
    jp = jmaj.build_majorants(jd)
    tp = tmaj.build_majorants(td)
    assert _eq(jp.brick_maj, tp.brick_maj)
    assert _eq(jp.super_maj, tp.super_maj)
    assert _eq(jp.rows, tp.rows)


def test_build_majorants_multi_superbrick():
    # > 64 voxels on one axis: several superbricks and ragged padding.
    data = np.random.default_rng(7).uniform(0, 1, (70, 9, 130)).astype(np.float32)
    jp = jmaj.build_majorants(jgrid.dense_grid_from_array(data))
    tp = tmaj.build_majorants(tgrid.dense_grid_from_array(data))
    assert _eq(jp.rows, tp.rows) and _eq(jp.super_maj, tp.super_maj)
    np.testing.assert_array_equal(tp.brick_maj.numpy(), jmaj.brick_majorant_reference(data))


@pytest.mark.parametrize("name", GRIDS)
def test_medium_tables_bitwise(name):
    jd, jt, td, tt = _grids(name)
    jm = jmed.Medium.from_grids(jd, jt)
    tm = tmed.Medium.from_grids(td, tt, device="cpu")
    assert tm.density_rows.shape[1] == jm.density_rows.shape[1] == (16 if name == "fire_plume_aligned" else 8)
    assert _eq(jm.density_rows, tm.density_rows)
    if name == "fire_plume":
        assert _eq(jm.temperature_rows, tm.temperature_rows)
    else:
        assert tm.temperature_rows is None  # folded, or no temperature


@pytest.mark.parametrize("name", GRIDS)
def test_temperature_on_density_grid_bitwise(name):
    jd, jt, td, tt = _grids(name)
    j = jmed.temperature_on_density_grid(jd, jt)
    t = tmed.temperature_on_density_grid(td, tt)
    if name == "fire_plume_aligned":
        assert _eq(j, t)
    else:
        assert j is None and t is None


def test_medium_from_numpy_equals_from_grids():
    jd, jt, td, tt = _grids("fire_plume")
    a = tmed.medium_from_numpy(jd, jt, device="cpu")
    b = tmed.Medium.from_grids(td, tt, device="cpu")
    assert torch.equal(a.density_rows, b.density_rows)
    assert torch.equal(a.temperature_rows, b.temperature_rows)


def test_medium_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmed.Medium.from_grids(tproc.fog_sphere(4.0, 1.0))


# ---------------- camera and color ----------------

def test_camera_rays_match_jax():
    cfg = tconfig.loads_configuration(json.dumps(SCENE))
    size = (64, 48)
    jc = JCamera.from_parameters(cfg.camera_parameters, size)
    tc = TCamera.from_parameters(cfg.camera_parameters, size, device="cpu")
    for a, b in ((jc.position, tc.position), (jc.raster_to_world_dir, tc.raster_to_world_dir),
                 (jc.raster_to_world_trans, tc.raster_to_world_trans)):
        assert _eq(a, b)
    tn = TCamera.from_numpy(np.asarray(jc.position), np.asarray(jc.raster_to_world_dir),
                            np.asarray(jc.raster_to_world_trans), jc.imaging_ratio, device="cpu")
    assert torch.equal(tn.raster_to_world_dir, tc.raster_to_world_dir)
    rng = np.random.default_rng(8)
    xy = np.stack([rng.integers(0, 64, 3000), rng.integers(0, 48, 3000)], -1).astype(np.int32)
    jit = (rng.uniform(0, 1, (3000, 2)) * 0.5).astype(np.float32)
    jo, jdir = jc.generate_rays(jnp.asarray(xy), jnp.asarray(jit))
    to, tdir = tc.generate_rays(torch.from_numpy(xy), torch.from_numpy(jit))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(tdir.numpy(), np.asarray(jdir), rtol=1e-6, atol=1e-7)


def test_film_to_srgb_matches_jax():
    film = np.random.default_rng(9).uniform(0, 2, (16, 24, 4)).astype(np.float32)
    film[..., 3] = 4.0
    film[0, 0] = 0.0  # unrendered pixel -> black, not NaN
    j = np.asarray(jcolor.film_to_srgb_u8(jnp.asarray(film))).astype(int)
    t = tcolor.film_to_srgb_u8(torch.from_numpy(film)).numpy().astype(int)
    # pow() may differ in the last ulp, which can move a truncation by one level.
    assert np.abs(j - t).max() <= 1 and (j == t).mean() > 0.99
    assert (t[0, 0] == 0).all()
