"""The wave kernel's wrapper, plain version and host-side pieces, on the CPU.

render_wave makes each pixel's camera ray, traces it and adds its sample to
the film; on a card that is one launch of render_wave_kernel, here it is
render_wave_plain. Held here:

- render_wave on CPU tensors against the composition it replaced
  (render_rays_wave -> film add), bitwise, for a whole wave, a chunked wave,
  the single pixel and a capped wave;
- render_wave_plain against the JAX render_rays_wave on the same scene and
  pixels (fog and fire): by the statistic of test_torch_integrator (log1p,
  sin and cos differ in the last ulp between XLA's and torch's CPU kernels
  and flip knife-edge events on a few lanes), weights exactly 1;
- the refill property: the film is bitwise the same when the lanes are fed
  in a random order, and in ragged batches as a refilling warp takes them;
- the camera ray written out elementwise, as the kernel computes it, against
  Camera.generate_rays and the JAX camera, within 5e-7 absolute (a product
  with K = 2 against a multiply-add chain: an ulp of a unit vector);
- the SIMT-efficiency and launch-timeline functions on hand-made counters;
- the constant cache: the same arrays for the same scene, new ones for a new
  medium, camera or jitter setting;
- the kernel's parameter layout: enum FParam / enum IParam parsed from the
  CUDA source as text against the names and order the wrapper builds.
"""
import dataclasses
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_path_tracer_tpu.grids import procedural as jproc
from volume_path_tracer_tpu.models.medium import Medium as JMedium
from volume_path_tracer_tpu.render import renderer as jren
from volume_path_tracer_tpu.utils.config import loads_configuration as j_loads
from volume_path_tracer_tpu_torch.grids import procedural as tproc
from volume_path_tracer_tpu_torch.models.medium import Medium
from volume_path_tracer_tpu_torch.render import megakernel as tmk
from volume_path_tracer_tpu_torch.render import renderer as tren
from volume_path_tracer_tpu_torch.utils import rng as trng
from volume_path_tracer_tpu_torch.utils.config import loads_configuration

torch.set_num_threads(2)

W, H = 32, 24
FOG_SCENE = {
    "worker_parameters": {
        "single_pixel": {"enabled": False, "coord": [0, 0]},
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
    "seed": 10, "output_size": [W, H], "tile_size": [8, 8], "num_waves": 2,
    "num_workers": 1, "volume_path": "vol.nvdb",
    "camera_parameters": {"position": [42.0, 0.0, 0.0], "look": [0.0, 0.0, 0.0],
                          "up": [0.0, 1.0, 0.0], "vfov_deg": 40.0, "imaging_ratio": 0.1},
}
FIRE_SCENE = dict(
    FOG_SCENE,
    volume_parameters={
        "sigma_s": 0.9, "sigma_a": 2.0, "henyey_greenstein_g": 0.7, "le_scale": 4e-8,
        "temperature_offset": 300.0, "temperature_scale": 43.0,
    },
    worker_parameters=dict(
        FOG_SCENE["worker_parameters"], max_depth=1_000_000,
        infinite_light={"xyz": [0.25, 0.25, 0.5], "multiplier": 10.0},
        distant_light={"xyz": [0.95047, 1.0, 1.08883], "multiplier": 20.0,
                       "inv_direction": [0.5, 1.0, 0.0]},
    ),
    camera_parameters=dict(FOG_SCENE["camera_parameters"], position=[60.0, 20.0, 0.0],
                           look=[0.0, 20.0, 0.0]),
)


def _scenes(name, max_iters=1024):
    """(the port's Scene on the CPU, the JAX Scene) of one case."""
    if name == "fog":
        cfg, grids, jgrids = FOG_SCENE, (tproc.fog_sphere(10.0, 3.0),), (jproc.fog_sphere(10.0, 3.0),)
    else:
        cfg = FIRE_SCENE
        grids, jgrids = tproc.fire_plume(height=40, radius=10.0), jproc.fire_plume(height=40, radius=10.0)
    sc = tren.Scene.from_config(loads_configuration(json.dumps(cfg)),
                                Medium.from_grids(*grids, device="cpu"), max_iters=max_iters, device="cpu")
    jsc = jren.Scene.from_config(j_loads(json.dumps(cfg)), JMedium.from_grids(*jgrids), max_iters=max_iters)
    return sc, jsc


@pytest.fixture(scope="module")
def fog():
    return _scenes("fog")[0]


def _wave(sc, film, pixels, wave=1, **kw):
    return tmk.render_wave(sc.medium, sc.params, sc.camera, sc.bb_table, film, pixels,
                           trng.mix_stream(sc.seed, wave), sc.use_jitter, sc.camera.imaging_ratio, **kw)


def _old_composition(sc, film, start, end, wave=1):
    """What render_wave_image did before render_wave: render_rays_wave on a
    slice of the pixel coordinates, then the film add."""
    coords = torch.from_numpy(tren.pixel_coords(W, H))
    pids = torch.arange(W * H, dtype=torch.int32)
    contrib, iters, ncap = tren.render_rays_wave(
        sc.medium, sc.params, sc.camera, sc.bb_table, coords[start:end], pids[start:end],
        sc.seed, wave, sc.use_jitter, sc.camera.imaging_ratio)
    film.view(-1, 4)[start:end] += contrib
    return int(iters), int(ncap)


@pytest.mark.parametrize("chunks", [
    [(0, W * H)], [(0, 100), (100, 357), (357, W * H)], [(12 * W + 16, 12 * W + 17)],
], ids=["whole", "chunked", "single_pixel"])
def test_render_wave_on_cpu_equals_the_old_composition(fog, chunks):
    rng = np.random.default_rng(1)
    film0 = torch.from_numpy(rng.uniform(0, 2, (H, W, 4)).astype(np.float32))
    film0[..., 3] = torch.floor(4 * film0[..., 3])  # sample counts
    new, old = film0.clone(), film0.clone()
    for start, end in chunks:
        it_n, nc_n = _wave(fog, new, range(start, end))
        it_o, nc_o = _old_composition(fog, old, start, end)
        assert (int(it_n), int(nc_n)) == (it_o, nc_o)
    assert torch.equal(new, old)
    covered = sum(e - s for s, e in chunks)
    assert int((new[..., 3] - film0[..., 3]).sum()) == covered


def test_render_wave_cap_counts_and_keeps_what_was_gathered(fog):
    capped = dataclasses.replace(fog, params=dataclasses.replace(fog.params, max_iters=6))
    new, old = (torch.zeros((H, W, 4)) for _ in range(2))
    it_n, nc_n = _wave(fog, new, range(0, W * H), max_iters=6)
    it_o, nc_o = _old_composition(capped, old, 0, W * H)
    assert int(it_n) == it_o == 6 and int(nc_n) == nc_o > 0
    assert torch.equal(new, old) and (new[..., 3] == 1).all()


@pytest.mark.parametrize("name", ["fog", "fire"])
def test_render_wave_plain_matches_jax(name):
    sc, jsc = _scenes(name)
    film = torch.zeros((H, W, 4))
    plain = tmk.PLAIN_WAVE_LAUNCHES
    iters, ncap = tmk.render_wave_plain(
        sc.medium, sc.params, sc.camera, sc.bb_table, film, range(0, W * H),
        trng.mix_stream(sc.seed, 1), sc.use_jitter, sc.camera.imaging_ratio)
    assert tmk.PLAIN_WAVE_LAUNCHES == plain + 1
    contrib, j_iters, j_ncap = jren.render_rays_wave(
        jsc.medium, jsc.params, jsc.camera, jren._bb_table_for(jsc.medium, jsc.params),
        jnp.asarray(jren.pixel_coords(W, H)), jnp.arange(W * H, dtype=jnp.int32),
        jsc.seed, 1, jsc.use_jitter, jsc.camera.imaging_ratio)
    ref = np.asarray(contrib)
    got = film.view(-1, 4).numpy()
    assert (got[:, 3] == 1).all() and (ref[:, 3] == 1).all()
    close = np.isclose(got[:, :3], ref[:, :3], rtol=1e-4, atol=1e-5).all(-1).mean()
    assert close > 0.95, close
    rel = np.abs(got[:, :3].mean(0) - ref[:, :3].mean(0)) / (np.abs(ref[:, :3].mean(0)) + 1e-9)
    assert (rel < 0.05).all(), rel
    assert int(ncap) == int(j_ncap) == 0
    assert got[:, :3].max() > 0
    if name == "fire":
        assert sc.bb_table is not None


def test_lane_order_and_batching_do_not_show_in_the_film(fog):
    """Draws are keyed on (pixel id, stream, lane counter): the plain loop
    gives every pixel the same sample whatever the order of the lanes, and
    when they are fed in ragged batches, as a refilling warp takes them."""
    n = W * H
    whole = torch.zeros((H, W, 4))
    it_w, nc_w = _wave(fog, whole, range(0, n))
    rng = np.random.default_rng(2)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    shuffled = torch.zeros((H, W, 4))
    it_s, nc_s = _wave(fog, shuffled, perm)
    assert torch.equal(whole, shuffled)
    assert (int(it_w), int(nc_w)) == (int(it_s), int(nc_s))
    batched = torch.zeros((H, W, 4))
    cuts = [0, *sorted(rng.choice(np.arange(1, n), size=9, replace=False).tolist()), n]
    its = [int(_wave(fog, batched, perm[a:b])[0]) for a, b in zip(cuts[:-1], cuts[1:])]
    assert torch.equal(whole, batched) and max(its) == int(it_w)


def test_camera_ray_elementwise_matches_generate_rays():
    """The ray as the kernel forms it: pt = (xy + 0.5) + jitter, three
    multiply-add chains, one normalisation."""
    sc, jsc = _scenes("fog")
    pids = torch.arange(W * H, dtype=torch.int32)
    u = trng.counter_uniforms(pids, trng.mix_stream(sc.seed, 3), tmk.JITTER_COUNTER, 2)
    jitter = u * 0.5
    raster = torch.from_numpy(tren.pixel_coords(W, H))
    o_ref, d_ref = sc.camera.generate_rays(raster, jitter)

    fields, _ = tmk._param_fields(sc.medium, sc.params, 0, 0, sc.camera, W, True, 0.1)
    p = {k: np.asarray(v, np.float32) for k, v in fields}
    px = (pids % W).numpy().astype(np.float32)
    py = (pids // W).numpy().astype(np.float32)
    ptx = (px + np.float32(0.5)) + u[:, 0].numpy() * p["P_JITTER"]
    pty = (py + np.float32(0.5)) + u[:, 1].numpy() * p["P_JITTER"]
    d = np.stack([ptx * p["P_CAM_MX"][a] + pty * p["P_CAM_MY"][a] + p["P_CAM_T"][a] for a in range(3)], -1)
    d = d / np.sqrt((d * d).sum(-1, keepdims=True))
    assert d.dtype == np.float32
    np.testing.assert_allclose(d, d_ref.numpy(), rtol=0, atol=5e-7)
    np.testing.assert_array_equal(np.broadcast_to(p["P_CAM_POS"], d.shape), o_ref.numpy())

    jo, jd = jsc.camera.generate_rays(jnp.asarray(raster.numpy()), jnp.asarray(jitter.numpy()))
    np.testing.assert_allclose(d, np.asarray(jd), rtol=0, atol=5e-7)
    np.testing.assert_array_equal(o_ref.numpy(), np.asarray(jo))


def test_simt_efficiency_on_hand_made_counters():
    steps = torch.tensor([4, 1, 1, 2, 8, 8, 8, 8], dtype=torch.int32)
    assert tmk.simt_efficiency(steps, group=4) == pytest.approx(40 / (4 * (4 + 8)))
    assert tmk.simt_efficiency(steps, group=8) == pytest.approx(40 / (8 * 8))
    # a ragged tail is padded with idle lanes
    assert tmk.simt_efficiency(torch.tensor([3, 3, 3, 3, 3]), group=4) == pytest.approx(15 / (4 * 6))
    assert tmk.simt_efficiency(torch.zeros(8, dtype=torch.int32)) == 1.0


def test_read_launch_stat_on_a_hand_made_timeline():
    # 4 warps that ran (first .. last clock), 1 that did not
    stat = torch.tensor([10, 160, 100, 200, 100, 300, 110, 400, 100, 1100, 0, 0], dtype=torch.int64)
    r = tmk.read_launch_stat(stat)
    assert r["warp_steps"] == 10 and r["lane_steps"] == 160 and r["simt_efficiency"] == 0.5
    assert r["warps"] == 4 and r["span_ns"] == 1000
    # after the median warp's end (300) fewer than half of the warps work
    assert r["half_idle_share"] == pytest.approx(0.8)
    assert tmk.read_launch_stat(torch.zeros(6, dtype=torch.int64))["warps"] == 0


def test_constants_are_made_once_per_scene_and_anew_for_a_new_one(fog):
    args = (fog.medium, fog.params, fog.bb_table, fog.camera, W, True, 0.1)
    a = tmk.kernel_constants(*args)
    b = tmk.kernel_constants(*args)
    assert a.fp is b.fp and a.ip is b.ip and a.scratch is b.scratch
    assert a.fp.dtype == np.float32 and a.ip.dtype == np.int32
    other_medium = Medium.from_grids(tproc.fog_sphere(10.0, 3.0), device="cpu")
    c = tmk.kernel_constants(other_medium, *args[1:])
    assert c.scratch is not a.scratch and c.fp is not a.fp
    np.testing.assert_array_equal(c.fp, a.fp)
    other_camera = dataclasses.replace(fog.camera, position=fog.camera.position + 1.0)
    d = tmk.kernel_constants(fog.medium, fog.params, fog.bb_table, other_camera, W, True, 0.1)
    assert d.fp is not a.fp and not np.array_equal(d.fp, a.fp)
    e = tmk.kernel_constants(fog.medium, fog.params, fog.bb_table, fog.camera, W, False, 0.1)
    assert e.fp is not a.fp
    # trace_lanes' entry (no camera) is its own
    assert tmk.kernel_constants(fog.medium, fog.params, fog.bb_table).fp is not a.fp


def test_constants_do_not_outlive_their_medium():
    sc = _scenes("fire")[0]
    before = len(tmk._CONSTANTS)
    k = tmk.kernel_constants(sc.medium, sc.params, sc.bb_table, sc.camera, W, True, 0.1)
    assert k.emission == 2 and k.pairs is not None and k.pairs.shape[1] == 6
    assert len(tmk._CONSTANTS) == before + 1
    del sc, k
    import gc

    gc.collect()
    assert len(tmk._CONSTANTS) == before


def _parse_enum(source, name):
    """{enumerator: value} of `enum name { ... }`, for enumerators written
    as NAME or NAME = OTHER + k."""
    body = re.search(r"enum\s+" + name + r"\s*\{([^}]*)\}", source).group(1)
    values, nxt = {}, 0
    for item in (x.strip() for x in body.split(",")):
        if not item:
            continue
        m = re.fullmatch(r"(\w+)(?:\s*=\s*(\w+)\s*\+\s*(\d+))?", item)
        assert m, item
        if m.group(2):
            nxt = values[m.group(2)] + int(m.group(3))
        values[m.group(1)] = nxt
        nxt += 1
    return values


@pytest.mark.parametrize("enum, which, total", [("FParam", 0, "NUM_FPARAMS"), ("IParam", 1, "NUM_IPARAMS")])
def test_parameter_layout_matches_the_kernel_source(fog, enum, which, total):
    with open(tmk.SOURCE) as f:
        in_source = _parse_enum(f.read(), enum)
    fields = tmk._param_fields(fog.medium, fog.params, 0, 0, fog.camera, W, True, 0.1)[which]
    offsets, size = tmk.param_layout(fields)
    assert in_source.pop(total) == size
    assert list(in_source.items()) == list(offsets.items())
    consts = tmk.kernel_constants(fog.medium, fog.params, fog.bb_table, fog.camera, W, True, 0.1)
    assert (consts.fp, consts.ip)[which].size == size


def test_render_wave_dispatch_by_device(fog):
    film = torch.zeros((H, W, 4))
    counts = (tmk.WAVE_LAUNCHES, tmk.LAUNCHES, tmk.PLAIN_WAVE_LAUNCHES, tmk.PLAIN_LAUNCHES)
    _wave(fog, film, range(0, 64))
    assert (tmk.WAVE_LAUNCHES, tmk.LAUNCHES, tmk.PLAIN_WAVE_LAUNCHES, tmk.PLAIN_LAUNCHES) == \
        (counts[0], counts[1], counts[2] + 1, counts[3])
    with pytest.raises(ValueError, match="unsupported device"):
        _wave(fog, film.to("meta"), range(0, 64))
    with pytest.raises(ValueError, match="contiguous"):
        _wave(fog, film, range(0, 64, 2))
