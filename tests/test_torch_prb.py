"""The port's gradient path against the JAX package and against itself.

Bitwise: blackbody_radiation_xyz_value_grad, build_majorants(bloat) and
fold_corner_rows. Then, on the four cases of tests/test_prb.py (absorption
only, emission with density and temperature, scattering with NEE, the packed
layout), the port's plain path replay (diff/prb.py trace_rays_prb on CPU
tensors) against torch autograd of its own bounded loop
(integrator.trace_rays_diff), and both against the JAX package's
trace_rays_prb and jax.grad of its trace_rays_diff. Then the port's
counterparts of tests/test_prb.py's record, fallback, truncation and
accounting tests, and one finite-difference check as in tests/test_diff.py.

Tolerances: the port's plain PRB and its own autograd oracle run the same
paths on the same draws; they differ by rounding only (rtol 1e-4 of the
gradient's largest entry, as tests/test_prb.py holds JAX). The port and the
JAX package differ in the last bit of log1p and of the step's quotients
(tests/test_torch_integrator.py), which can flip a knife-edge event on a
lane; the cotangent is therefore set to zero on every lane whose port and
JAX forward radiance differ beyond rtol 1e-4 before gradients are compared.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_path_tracer_tpu.diff import prb as jprb
from volume_path_tracer_tpu.grids import grid as jgrid
from volume_path_tracer_tpu.grids import majorant as jmaj
from volume_path_tracer_tpu.models import medium as jmed
from volume_path_tracer_tpu.render import integrator as jint
from volume_path_tracer_tpu.utils import rng as jrng
from volume_path_tracer_tpu.utils import spectral as jspec
from volume_path_tracer_tpu_torch.diff import prb as tprb
from volume_path_tracer_tpu_torch.grids import grid as tgrid
from volume_path_tracer_tpu_torch.grids import majorant as tmaj
from volume_path_tracer_tpu_torch.models import medium as tmed
from volume_path_tracer_tpu_torch.render import integrator as tint
from volume_path_tracer_tpu_torch.render import megakernel as tmk
from volume_path_tracer_tpu_torch.utils import rng as trng
from volume_path_tracer_tpu_torch.utils import spectral as tspec

torch.set_num_threads(2)

BASE = dict(
    sigma_a=0.4, sigma_s=0.0, hg_g=0.0, le_scale=0.0,
    temperature_offset=300.0, temperature_scale=40.0,
    infinite_xyz=(1.0, 1.0, 1.0), infinite_multiplier=1.0,
    distant_xyz=(0.0, 0.0, 0.0), distant_multiplier=0.0,
    distant_inv_direction=(0.0, 1.0, 0.0), max_depth=50, max_iters=96,
)
NEE = dict(distant_xyz=(0.95, 1.0, 1.09), distant_multiplier=5.0, distant_inv_direction=(0.3, 0.8, 0.2))
# The four cases of tests/test_prb.py TestReplayMatchesAD, at max_iters 96
# (truncation parity keeps a cut path's gradient exact on both sides).
CASES = {
    "absorption": (dict(), 0.6, False, False),
    "emission": (dict(sigma_a=0.5, le_scale=5e-3, infinite_multiplier=0.2), 0.5, True, False),
    "nee": (dict(sigma_a=0.1, sigma_s=0.6, hg_g=0.4, infinite_multiplier=0.3, max_depth=40, **NEE), 0.5, False, False),
    "packed": (dict(sigma_a=0.3, sigma_s=0.5, hg_g=0.4, le_scale=4e-3, infinite_multiplier=0.3, max_depth=40, **NEE),
               0.5, True, True),
}
N = 1024
STREAM = (7, 2)


def _bb():
    return jspec.blackbody_xyz_table()


def _grids(rho_value, emissive, seed=5):
    """8^3 density (uniform plus numpy noise) and temperature grids."""
    rng = np.random.default_rng(seed)
    rho = (rho_value * (0.75 + 0.5 * rng.random((8, 8, 8)))).astype(np.float32)
    temp = (12.0 + 2.0 * rng.random((8, 8, 8))).astype(np.float32) if emissive else None
    return rho, temp


def _rays(n, seed=3):
    rng = np.random.default_rng(seed)
    o = np.stack([np.full(n, -3.0), rng.uniform(1.0, 7.0, n), rng.uniform(1.0, 7.0, n)], -1).astype(np.float32)
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    return o, d, np.arange(n, dtype=np.int32)


def _cotangent(n, seed=11):
    return np.random.default_rng(seed).uniform(0.2, 1.0, (n, 3)).astype(np.float32)


def port_medium(rho, temp, pack, bloat=0.2):
    """The port's gradient-mode medium over tensors (which may require grad)."""
    g = tgrid.dense_grid_from_array(rho)
    t = tgrid.dense_grid_from_array(temp) if temp is not None else None
    maj = tmaj.build_majorants(g, bloat=bloat)
    return tmed.Medium(
        density=g, majorants=maj, temperature=t,
        density_rows=tmed.pack_fused_rows(g.data.detach(), maj) if pack else None,
        temperature_rows=tgrid.pack_corner_rows(t.data.detach()) if (pack and t is not None) else None,
    )


def jax_medium(rho, temp, pack, bloat=0.2):
    g = jgrid.dense_grid_from_array(jnp.asarray(rho))
    t = jgrid.dense_grid_from_array(jnp.asarray(temp)) if temp is not None else None
    maj = jmaj.build_majorants(g, bloat=bloat)
    return jmed.Medium(
        density=g, majorants=maj, temperature=t,
        density_rows=jmed.pack_fused_rows(g.data, maj) if pack else None,
        temperature_rows=jgrid.pack_corner_rows(t.data) if (pack and t is not None) else None,
    )


def port_grads(fn, rho, temp, g):
    """(d rho, d temp) of sum(fn(medium) * g) by torch autograd."""
    r = torch.tensor(rho, requires_grad=True)
    t = torch.tensor(temp, requires_grad=True) if temp is not None else None
    L = fn(r, t)
    (L * torch.from_numpy(g)).sum().backward()
    return r.grad.numpy(), (t.grad.numpy() if t is not None else None), L.detach().numpy()


def value_and_vjp(fn, rho, temp, g):
    """(fn(rho, temp), the vjp of cotangent g) as numpy, through one jitted
    function (compiled once per fn: the JAX loops cost seconds to compile)."""
    key = id(fn)
    if key not in _JIT:
        def both(r, t, gv):
            L, vjp = jax.vjp(fn, r, t)
            return L, vjp(gv)

        _JIT.clear()
        _JIT[key] = (fn, jax.jit(both))
    L, (gr, gt) = _JIT[key][1](jnp.asarray(rho), None if temp is None else jnp.asarray(temp), jnp.asarray(g))
    return np.asarray(L), (np.asarray(gr), None if gt is None else np.asarray(gt))


_JIT = {}


def assert_grad_close(got, want, rtol=1e-4, what=""):
    scale = np.abs(want).max()
    assert scale > 0, f"{what}: degenerate test, zero gradient"
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0, err_msg=what)


@functools.lru_cache(maxsize=None)
def _case(name):
    """The case's inputs and the port's two gradients (PRB, autograd oracle),
    with the full cotangent."""
    kw, rho_value, emissive, pack = CASES[name]
    prm = tint.IntegratorParams(**dict(BASE, **kw))
    rho, temp = _grids(rho_value, emissive)
    bb = torch.from_numpy(_bb()) if emissive else None
    o, d, pids = (torch.from_numpy(x) for x in _rays(N))
    stream = trng.mix_stream(*STREAM)
    g = _cotangent(N)

    def prb(r, t):
        return tprb.trace_rays_prb(port_medium(r, t, pack), prm, bb, o, d, pids, stream)

    def oracle(r, t):
        return tint.trace_rays_diff(port_medium(r, t, False), prm, bb, o, d, pids, stream, prm.max_iters)

    return dict(kw=kw, rho=rho, temp=temp, pack=pack, g=g, prm=prm,
                prb=port_grads(prb, rho, temp, g), oracle=port_grads(oracle, rho, temp, g))


# ---------------------------------------------------------------- bitwise ----

def test_blackbody_value_grad_bitwise():
    table = _bb()
    t = np.concatenate([np.array([-50.0, 0.0, 1e-3, 99.999, 100.0, 300.0, 12345.6, 49_899.99, 49_900.0,
                                  49_999.0, 60_000.0], np.float32),
                        np.random.default_rng(0).uniform(-100.0, 55_000.0, 4096).astype(np.float32)])
    jv, jg = jspec.blackbody_radiation_xyz_value_grad(jnp.asarray(table), jnp.asarray(t))
    tv, tg = tspec.blackbody_radiation_xyz_value_grad(torch.from_numpy(table), torch.from_numpy(t))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    # The value is the forward's pair lookup, bit for bit.
    pairs = tspec.blackbody_pairs(torch.from_numpy(table))
    np.testing.assert_array_equal(tv.numpy(), tspec.blackbody_radiation_xyz_from_pairs(pairs, torch.from_numpy(t)).numpy())
    assert (tg.numpy() != 0).any() and (tg.numpy()[t <= 0] == 0).all()


@pytest.mark.parametrize("bloat", [0.0, 0.1, 0.2])
def test_build_majorants_bloat_bitwise(bloat):
    rng = np.random.default_rng(1)
    data = (rng.random((13, 9, 21)) * (rng.random((13, 9, 21)) < 0.4)).astype(np.float32)
    j = jmaj.build_majorants(jgrid.dense_grid_from_array(jnp.asarray(data), (-3, 2, 0)), bloat=bloat)
    t = tmaj.build_majorants(tgrid.dense_grid_from_array(data, (-3, 2, 0)), bloat=bloat)
    for field in ("brick_maj", "super_maj", "rows"):
        np.testing.assert_array_equal(getattr(t, field).numpy(), np.asarray(getattr(j, field)), err_msg=field)
    if bloat:
        plain = tmaj.build_majorants(tgrid.dense_grid_from_array(data, (-3, 2, 0)))
        nz = plain.brick_maj > 0
        assert bool((t.brick_maj[nz] > plain.brick_maj[nz]).all()) and bool((t.brick_maj[~nz] == 0).all())


def test_fold_corner_rows_bitwise():
    shape = (5, 7, 4)
    rows = np.random.default_rng(2).standard_normal(((5 + 1) * (7 + 1) * (4 + 1), 8)).astype(np.float32)
    np.testing.assert_array_equal(tprb.fold_corner_rows(torch.from_numpy(rows), shape).numpy(),
                                  np.asarray(jprb.fold_corner_rows(jnp.asarray(rows), shape)))


def test_direct_scatter_adds_masked_rows():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 6, 64)
    vals = rng.standard_normal((64, 8)).astype(np.float32)
    nz = rng.random(64) < 0.5
    got = tprb.direct_scatter(torch.zeros((6, 8)), torch.from_numpy(rows), torch.from_numpy(vals), torch.from_numpy(nz))
    want = jprb.direct_scatter(jnp.zeros((6, 8)), jnp.asarray(rows), jnp.asarray(vals), jnp.asarray(nz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- the autograd oracle ----

def test_trace_rays_diff_value_equals_trace_rays():
    """A DONE lane's step changes nothing: the bounded loop's value is
    trace_rays's radiance at max_iters = n_iters, bitwise."""
    prm = tint.IntegratorParams(**dict(BASE, **CASES["packed"][0]))
    rho, temp = _grids(0.5, True)
    med = port_medium(torch.from_numpy(rho), torch.from_numpy(temp), False)
    bb = torch.from_numpy(_bb())
    o, d, pids = (torch.from_numpy(x) for x in _rays(256))
    stream = trng.mix_stream(*STREAM)
    with torch.no_grad():
        L_diff = tint.trace_rays_diff(med, prm, bb, o, d, pids, stream, prm.max_iters)
    L, _, _ = tint.trace_rays(med, prm, bb, o, d, pids, stream)
    assert torch.equal(L_diff, L)


def test_trace_rays_diff_grads_match_jax():
    """torch autograd of the port's bounded loop against jax.grad of the JAX
    trace_rays_diff: emission (density and temperature) with NEE."""
    kw = dict(sigma_a=0.3, sigma_s=0.5, hg_g=0.4, le_scale=4e-3, infinite_multiplier=0.3, max_depth=40, **NEE)
    n, n_iters = 256, 48
    rho, temp = _grids(0.5, True)
    o, d, pids = _rays(n)
    g = _cotangent(n)
    bb = _bb()
    jprm = jint.IntegratorParams(**dict(BASE, **kw, max_iters=n_iters))
    stream = jrng.mix_stream(*STREAM)

    def jfn(r, t):
        return jint.trace_rays_diff(jax_medium(r, t, False), jprm, jnp.asarray(bb), jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(pids), stream, n_iters)

    L_j, _ = value_and_vjp(jfn, rho, temp, g)
    prm = tint.IntegratorParams(**dict(BASE, **kw, max_iters=n_iters))
    args = (torch.from_numpy(bb), torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(pids), trng.mix_stream(*STREAM))
    with torch.no_grad():
        L_t = tint.trace_rays_diff(port_medium(torch.from_numpy(rho), torch.from_numpy(temp), False), prm, *args[:4],
                                   args[4], n_iters).numpy()
    agree = np.isclose(L_t, L_j, rtol=1e-4, atol=1e-7).all(-1)
    assert agree.mean() > 0.95, agree.mean()
    gm = np.where(agree[:, None], g, 0.0).astype(np.float32)
    _, (jd, jt) = value_and_vjp(jfn, rho, temp, gm)
    td, tt, _ = port_grads(lambda r, t: tint.trace_rays_diff(port_medium(r, t, False), prm, *args[:4], args[4], n_iters),
                           rho, temp, gm)
    assert_grad_close(td, jd, what="density")
    assert_grad_close(tt, jt, what="temperature")


def test_render_radiance_diff_is_the_scene_bounded_loop():
    """render_radiance_diff: the scene's jittered camera rays through
    trace_rays_diff (the value of trace_rays), differentiable w.r.t. a
    medium override's density."""
    from volume_path_tracer_tpu_torch.render.renderer import Scene, pixel_coords, render_radiance_diff
    from volume_path_tracer_tpu_torch.utils.config import loads_configuration
    import json

    cfg = loads_configuration(json.dumps({
        "worker_parameters": {"single_pixel": {"enabled": False, "coord": [0, 0]},
                              "infinite_light": {"xyz": [1.0, 1.0, 1.0], "multiplier": 0.3},
                              "distant_light": {"xyz": [0.95, 1.0, 1.09], "multiplier": 5.0,
                                                "inv_direction": [0.3, 0.8, 0.2]},
                              "use_jitter": True, "max_depth": 40},
        "volume_parameters": {"sigma_s": 0.6, "sigma_a": 0.1, "henyey_greenstein_g": 0.4, "le_scale": 0.0,
                              "temperature_offset": 300.0, "temperature_scale": 40.0},
        "seed": 4, "output_size": [12, 8], "tile_size": [4, 4], "num_waves": 1, "num_workers": 1,
        "volume_path": "unused.nvdb",
        "camera_parameters": {"position": [20.0, 4.0, 4.0], "look": [4.0, 4.0, 4.0], "up": [0.0, 1.0, 0.0],
                              "vfov_deg": 40.0, "imaging_ratio": 0.1},
    }))
    rho, _ = _grids(0.5, False)
    scene = Scene.from_config(cfg, port_medium(torch.from_numpy(rho), None, False), max_iters=64, device="cpu")
    raster = torch.from_numpy(pixel_coords(12, 8))
    pids = torch.arange(96, dtype=torch.int32)
    r = torch.tensor(rho, requires_grad=True)
    L = render_radiance_diff(scene, 2, 64, raster, pids, medium=port_medium(r, None, False))
    stream = trng.mix_stream(4, 2)
    u = trng.counter_uniforms(pids, stream, tmk.JITTER_COUNTER, 2)
    o, d = scene.camera.generate_rays(raster, u * 0.5)
    L_ref, _, _ = tint.trace_rays(scene.medium, scene.params, None, o, d, pids, stream)
    assert torch.equal(L.detach(), L_ref)
    L[:, 1].sum().backward()
    assert bool(torch.isfinite(r.grad).all()) and float(r.grad.abs().max()) > 0


# ---------------------------------------------------------- path replay ----

@pytest.mark.parametrize("name", list(CASES))
def test_prb_matches_own_autograd(name):
    """The port's plain path replay equals torch autograd of its own bounded
    loop (tests/test_prb.py TestReplayMatchesAD, for the port)."""
    c = _case(name)
    (pd, pt, L_p), (ad, at, L_a) = c["prb"], c["oracle"]
    np.testing.assert_array_equal(L_p, L_a)
    assert_grad_close(pd, ad, what="density")
    if c["temp"] is not None:
        assert_grad_close(pt, at, what="temperature")


@pytest.mark.parametrize("name", list(CASES))
def test_prb_matches_jax_prb(name):
    """The port's plain path replay against the JAX trace_rays_prb (its
    record pass and replay_grads), with the cotangent masked to lanes whose
    forward radiance agrees. 512 lanes: one compaction stage, the cheapest
    JAX compile."""
    kw, rho_value, emissive, pack = CASES[name]
    n = 512
    rho, temp = _grids(rho_value, emissive)
    o, d, pids = _rays(n)
    g = _cotangent(n)
    jbb = jnp.asarray(_bb()) if emissive else None
    jprm = jint.IntegratorParams(**dict(BASE, **kw))
    stream = jrng.mix_stream(*STREAM)
    jo, jd_, jp = (jnp.asarray(x) for x in (o, d, pids))

    def jfn(r, t):
        return jprb.trace_rays_prb(jax_medium(r, t, pack), jprm, jbb, jo, jd_, jp, stream)

    L_j, _ = value_and_vjp(jfn, rho, temp, g)
    prm = tint.IntegratorParams(**dict(BASE, **kw))
    tbb = torch.from_numpy(_bb()) if emissive else None
    to, tdir, tp = (torch.from_numpy(x) for x in (o, d, pids))

    def port(r, t):
        return tprb.trace_rays_prb(port_medium(r, t, pack), prm, tbb, to, tdir, tp, trng.mix_stream(*STREAM))

    with torch.no_grad():
        L_p = port(torch.from_numpy(rho), torch.from_numpy(temp) if emissive else None).numpy()
    agree = np.isclose(L_p, np.asarray(L_j), rtol=1e-4, atol=1e-7).all(-1)
    assert agree.mean() > 0.95, agree.mean()
    gm = np.where(agree[:, None], g, 0.0).astype(np.float32)
    _, (jgd, jgt) = value_and_vjp(jfn, rho, temp, gm)
    td, tt, _ = port_grads(port, rho, temp, gm)
    assert_grad_close(td, np.asarray(jgd), what="density")
    if emissive:
        assert_grad_close(tt, np.asarray(jgt), what="temperature")


def _record_scene():
    """tests/test_prb.py TestSavedWalkResiduals._scene, for both packages."""
    rng = np.random.default_rng(5)
    rho = (rng.uniform(0.0, 1.2, (9, 9, 9)) ** 2).astype(np.float32)
    kw = dict(sigma_a=0.1, sigma_s=0.5, hg_g=0.3, distant_xyz=(0.95, 1.0, 1.09), distant_multiplier=5.0,
              distant_inv_direction=(0.3, 1.0, 0.2), max_iters=256)
    o = np.tile(np.array([[-3.0, 3.0, 3.0]], np.float32), (64, 1))
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (64, 1))
    pids = np.arange(64, dtype=np.int32)
    return rho, kw, o, d, pids, 11


def test_record_forward_is_bitwise_the_production_forward():
    rho, kw, o, d, pids, stream = _record_scene()
    med = port_medium(torch.from_numpy(rho), None, True)
    prm = tint.IntegratorParams(**dict(BASE, **kw))
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(pids), stream)
    L_ref, _, _ = tint.trace_rays(med, prm, None, *args)
    L_rec, tf = tprb._trace_rays_record(med, prm, None, *args, 8)
    assert torch.equal(L_ref, L_rec)
    tfn = tf.numpy()
    assert (tfn != 0).any()
    neg = -tfn[tfn < 0]
    np.testing.assert_array_equal(neg, np.round(neg))
    assert (neg <= prm.max_iters).all() and np.isfinite(tfn).all()


@pytest.mark.parametrize("k_walks", [8, 1], ids=["saved", "slot_overflow"])
def test_saved_replay_equals_pre_grad_fallback(k_walks):
    """The recorded residuals replay each walk once (GRAD); with 1 slot every
    later walk falls back to PRE+GRAD: both equal the all-fallback replay
    (tests/test_prb.py test_saved_replay_equals_pre_grad_fallback and
    test_slot_overflow_falls_back_per_walk)."""
    rho, kw, o, d, pids, stream = _record_scene()
    med = port_medium(torch.from_numpy(rho), None, True)
    prm = tint.IntegratorParams(**dict(BASE, **kw))
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(pids), stream)
    L, tf = tprb._trace_rays_record(med, prm, None, *args, k_walks)
    g = torch.ones((64, 3))
    dd_saved, _ = tprb.replay_grads(med, prm, None, *args, L, g, tf=tf)
    dd_fallback, _ = tprb.replay_grads(med, prm, None, *args, L, g, tf=None)
    assert float(dd_fallback.abs().max()) > 0
    np.testing.assert_allclose(dd_saved.numpy(), dd_fallback.numpy(), rtol=2e-4, atol=1e-6)


def test_truncation_parity():
    """With a cap of 12 steps the forward cuts lanes mid-volume; the replay
    gives exactly the truncated estimator's gradient."""
    rho = np.full((6, 6, 6), 0.8, np.float32)
    prm = tint.IntegratorParams(**dict(BASE, sigma_a=0.2, sigma_s=0.4, hg_g=0.0, max_iters=12))
    o = torch.tensor([[-3.0, 3.0, 3.0]]).expand(2048, 3).contiguous()
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(2048, 3).contiguous()
    pids = torch.arange(2048, dtype=torch.int32)
    stream = trng.mix_stream(*STREAM)
    g = np.full((2048, 3), 1.0 / 2048, np.float32)
    pd, _, _ = port_grads(lambda r, t: tprb.trace_rays_prb(port_medium(r, t, False), prm, None, o, d, pids, stream),
                          rho, None, g)
    ad, _, _ = port_grads(lambda r, t: tint.trace_rays_diff(port_medium(r, t, False), prm, None, o, d, pids, stream,
                                                            prm.max_iters), rho, None, g)
    _, _, n_capped = tint.trace_rays(port_medium(torch.from_numpy(rho), None, False), prm, None, o, d, pids, stream)
    assert int(n_capped) > 0
    assert_grad_close(pd, ad)


@pytest.mark.parametrize("k_walks", [0, 16], ids=["pre_grad", "recorded"])
def test_accounting_invariant(k_walks):
    """The replayed <g, L> reproduces <g, L_forward> lane for lane: the suffix
    bookkeeping behind every score factor is exact, through the NEE walks and
    truncation parity."""
    prm = tint.IntegratorParams(**dict(BASE, **CASES["nee"][0], max_iters=256))
    rho, _ = _grids(0.5, False)
    med = port_medium(torch.from_numpy(rho), None, False)
    o, d, pids = (torch.from_numpy(x) for x in _rays(2048))
    stream = trng.mix_stream(*STREAM)
    L, tf = tprb._trace_rays_record(med, prm, None, o, d, pids, stream, k_walks)
    gv = torch.tensor([[0.3, 1.0, 0.2]]).expand(2048, 3).contiguous()
    _, _, acc, tot = tprb.replay_grads(med, prm, None, o, d, pids, stream, L, gv, with_check=True,
                                       tf=tf if k_walks else None)
    assert float(tot.abs().max()) > 0
    np.testing.assert_allclose(acc.numpy(), tot.numpy(), atol=1e-5, rtol=1e-5)


def test_finite_difference_absorption():
    """The replay gradient of mean Y radiance at the voxel the chord crosses
    against central differences of the forward (same draws on both sides),
    as tests/test_diff.py TestFiniteDifference."""
    n = 6
    rho = np.full((n, n, n), 0.6, np.float32)
    prm = tint.IntegratorParams(**dict(BASE, max_iters=192))
    n_rays = 40_000
    o = torch.tensor([[-3.0, 3.0, 3.0]]).expand(n_rays, 3).contiguous()
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(n_rays, 3).contiguous()
    pids = torch.arange(n_rays, dtype=torch.int32)
    stream = trng.mix_stream(1, 1)

    def f(data):
        L, _, _ = tint.trace_rays(port_medium(torch.from_numpy(data), None, False), prm, None, o, d, pids, stream)
        return float(L[:, 1].mean())

    g = np.full((n_rays, 3), 0.0, np.float32)
    g[:, 1] = 1.0 / n_rays
    ad, _, _ = port_grads(lambda r, t: tprb.trace_rays_prb(port_medium(r, t, False), prm, None, o, d, pids, stream),
                          rho, None, g)
    eps = 0.05
    dp = rho.copy(); dp[3, 3, 3] += eps
    dm = rho.copy(); dm[3, 3, 3] -= eps
    fd = (f(dp) - f(dm)) / (2 * eps)
    assert fd < 0 and ad[3, 3, 3] < 0, (fd, ad[3, 3, 3])
    np.testing.assert_allclose(ad[3, 3, 3], fd, rtol=0.2)


def test_prb_is_an_autograd_function_on_the_plain_versions():
    """On CPU tensors trace_rays_prb records and replays through the plain
    versions (counted), its output carries the Function's backward, and the
    forward alone (no gradient wanted) records nothing."""
    c = CASES["nee"]
    prm = tint.IntegratorParams(**dict(BASE, **c[0]))
    rho, _ = _grids(0.5, False)
    o, d, pids = (torch.from_numpy(x) for x in _rays(64))
    r = torch.tensor(rho, requires_grad=True)
    before = (tmk.PLAIN_RECORD_LAUNCHES, tmk.PLAIN_REPLAY_LAUNCHES, tmk.RECORD_LAUNCHES, tmk.REPLAY_LAUNCHES)
    L = tprb.trace_rays_prb(port_medium(r, None, False), prm, None, o, d, pids, 5)
    assert type(L.grad_fn).__name__ == "_PathReplayBackward"
    L.sum().backward()
    after = (tmk.PLAIN_RECORD_LAUNCHES, tmk.PLAIN_REPLAY_LAUNCHES, tmk.RECORD_LAUNCHES, tmk.REPLAY_LAUNCHES)
    assert after == (before[0] + 1, before[1] + 1, before[2], before[3])
    with torch.no_grad():
        L2 = tprb.trace_rays_prb(port_medium(r, None, False), prm, None, o, d, pids, 5)
    assert tmk.PLAIN_RECORD_LAUNCHES == after[0] and torch.equal(L2, L.detach())
    with pytest.raises(ValueError, match="unsupported device"):
        tmk.replay_lanes(port_medium(r.detach(), None, False), prm, None, o.to("meta"), d.to("meta"), pids, 5,
                         L.detach().to("meta"), torch.ones((64, 3), device="meta"))
    with pytest.raises(ValueError, match="2\\^24"):
        tprb._trace_rays_record(port_medium(r.detach(), None, False), dataclass_replace(prm, max_iters=2**24),
                                None, o, d, pids, 5, 4)


def dataclass_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)
