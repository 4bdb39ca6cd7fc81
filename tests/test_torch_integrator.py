"""The port's plain integrator and the lane kernel's plain version against JAX.

First one plain make_step against the JAX make_step on the same state and
the same uniforms. Then, on the three cases of tests/test_megakernel.py at
N = 1024 (the scattering fog sphere, the misaligned emissive fire plume with
8-wide rows, the aligned fire with 16-wide rows), the port's trace_rays
(compacted wavefront) and trace_lanes_plain (the CUDA kernel's plain
version, full width) each against the JAX trace_rays and against the Pallas
kernel run on the CPU (trace_rays_fused(interpret=True)).

Tolerances: draws and tables are bitwise equal (test_torch_rng,
test_torch_tables); log1p, sin and cos may differ in the last ulp between
XLA's and torch's CPU kernels, and the port's step takes its quotients by
the segment's majorant and by the voxel size through a reciprocal (as its
CUDA kernel does, where a division is the longest link of the step's chain)
where the JAX step divides: a last-bit difference in the free-flight
distance and the event probabilities. Either flips a knife-edge event on a
few lanes. One step is held at rtol=1e-5, atol=1e-6 on more than 99% of
lanes, as before that change (a last bit is 6e-8). Paths are therefore held by the statistic the JAX package holds its
own two tracers to (tests/test_megakernel.py): more than 95% of lanes close
at rtol=1e-4, atol=1e-5, channel means within 5%, equal n_capped.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_path_tracer_tpu.grids import grid as jgrid
from volume_path_tracer_tpu.grids import procedural as jproc
from volume_path_tracer_tpu.models.medium import Medium as JMedium
from volume_path_tracer_tpu.render import integrator as jint
from volume_path_tracer_tpu.render.megakernel import trace_rays_fused as j_trace_rays_fused
from volume_path_tracer_tpu.utils import rng as jrng
from volume_path_tracer_tpu.utils import spectral as jspec
from volume_path_tracer_tpu_torch.models.medium import medium_from_numpy
from volume_path_tracer_tpu_torch.render import integrator as tint
from volume_path_tracer_tpu_torch.render import megakernel as tmk
from volume_path_tracer_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

FOG = dict(
    sigma_a=0.0, sigma_s=0.15, hg_g=0.4, le_scale=0.0,
    temperature_offset=300.0, temperature_scale=40.0,
    infinite_xyz=(4.382, 3.509, 17.603), infinite_multiplier=0.14,
    distant_xyz=(0.95047, 1.0, 1.08883), distant_multiplier=50.0,
    distant_inv_direction=(0.5826, 0.7660, 0.2717), max_depth=100, max_iters=512,
)
FIRE = dict(
    sigma_a=2.0, sigma_s=0.9, hg_g=0.7, le_scale=4e-8,
    temperature_offset=300.0, temperature_scale=43.0,
    infinite_xyz=(0.25, 0.25, 0.5), infinite_multiplier=10.0,
    distant_xyz=(0.95047, 1.0, 1.08883), distant_multiplier=20.0,
    distant_inv_direction=(0.5, 1.0, 0.0), max_depth=1_000_000, max_iters=2048,
)
CASES = ["fog_sphere", "fire_plume_8wide", "fire_plume_16wide"]
N = 1024


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs of one case, for both packages, from one numpy seed."""
    rng = np.random.default_rng(0)
    if name == "fog_sphere":
        jd, jt, prm, bb = jproc.fog_sphere(12.0, 3.0), None, FOG, None
        o = np.stack([np.full(N, -40.0), rng.uniform(-14, 14, N), rng.uniform(-14, 14, N)], -1)
    else:
        jd, jt = jproc.fire_plume(height=40, radius=10.0)
        if name == "fire_plume_16wide":
            jt = jgrid.dense_grid_from_array(np.asarray(jt.data), jt.origin_ijk, jt.voxel_size, (0.0, 0.0, 0.0))
        prm, bb = FIRE, jspec.blackbody_xyz_table()
        o = np.stack([np.full(N, -40.0), rng.uniform(5, 35, N), rng.uniform(-10, 10, N)], -1)
    o = o.astype(np.float32)
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (N, 1))
    pids = np.arange(N, dtype=np.int32)
    return dict(jd=jd, jt=jt, prm=prm, bb=bb, o=o, d=d, pids=pids, seed=(3, 1))


@functools.lru_cache(maxsize=None)
def _jax_results(name):
    """(JAX trace_rays, Pallas kernel in interpret mode), each (L, n_capped)."""
    c = _case(name)
    med = JMedium.from_grids(c["jd"], c["jt"])
    prm = jint.IntegratorParams(**c["prm"])
    bb = None if c["bb"] is None else jnp.asarray(c["bb"])
    args = (med, prm, bb, jnp.asarray(c["o"]), jnp.asarray(c["d"]), jnp.asarray(c["pids"]),
            jrng.mix_stream(*c["seed"]))
    L_x, _, nc_x = jint.trace_rays(*args)
    L_p, _, nc_p = j_trace_rays_fused(*args, block_lanes=1024, interpret=True)
    return (np.asarray(L_x), int(nc_x)), (np.asarray(L_p), int(nc_p))


def _port(name):
    c = _case(name)
    med = medium_from_numpy(c["jd"], c["jt"], device="cpu")
    prm = tint.IntegratorParams(**c["prm"])
    bb = None if c["bb"] is None else torch.from_numpy(c["bb"])
    return med, prm, bb, torch.from_numpy(c["o"]), torch.from_numpy(c["d"]), torch.from_numpy(c["pids"]), \
        trng.mix_stream(*c["seed"])


def _assert_statistic(L, ref, nc, nc_ref, what):
    close = np.isclose(L, ref, rtol=1e-4, atol=1e-5).all(-1).mean()
    assert close > 0.95, f"{what}: lane-close {close}"
    rel = np.abs(L.mean(0) - ref.mean(0)) / (np.abs(ref.mean(0)) + 1e-9)
    assert (rel < 0.05).all(), f"{what}: channel means differ by {rel}"
    assert nc == nc_ref, f"{what}: n_capped {nc} != {nc_ref}"


def _jax_state_to_port(st) -> tint.RayState:
    return tint.RayState(*(torch.from_numpy(np.array(x)) for x in st))


@pytest.mark.parametrize("name", CASES)
def test_make_step_matches_jax(name):
    """One step on a mid-flight state, same state and same uniforms."""
    c = _case(name)
    jmed = JMedium.from_grids(c["jd"], c["jt"])
    jprm = jint.IntegratorParams(**c["prm"])
    bb = None if c["bb"] is None else jnp.asarray(c["bb"])
    jstep = jint.make_step(jmed, jprm, bb)
    pids = jnp.asarray(c["pids"])
    stream = jrng.mix_stream(*c["seed"])
    st = jint.init_state(jmed, jnp.asarray(c["o"]), jnp.asarray(c["d"]), jprm)
    for _ in range(12):  # move into the volume: collisions, shadow rays, retirements
        st = jstep(st, jrng.counter_uniforms(pids, stream, st.ctr, 4))
    u = np.array(jrng.counter_uniforms(pids, stream, st.ctr, 4))
    j_next = jstep(st, jnp.asarray(u))

    med, prm, tbb, *_ = _port(name)
    t_next = tint.make_step(med, prm, tbb)(_jax_state_to_port(st), torch.from_numpy(u))

    agree = np.ones(N, bool)
    for field, a, b in zip(tint.RayState._fields, j_next, t_next):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, field
        if a.dtype == np.float32:
            ok = np.isclose(a, b, rtol=1e-5, atol=1e-6)
        else:
            ok = a == b
        agree &= ok.reshape(N, -1).all(-1)
    modes = np.asarray(st.mode)
    assert (modes == jint.SHADOW).any() and (modes == jint.CAM).any()
    assert agree.mean() > 0.99, agree.mean()


@pytest.mark.parametrize("name", CASES)
def test_trace_rays_matches_jax(name):
    (L_x, nc_x), (L_p, nc_p) = _jax_results(name)
    L, it, nc = tint.trace_rays(*_port(name))
    L = L.numpy()
    assert int(it) > 0
    _assert_statistic(L, L_x, int(nc), nc_x, "port trace_rays vs JAX trace_rays")
    _assert_statistic(L, L_p, int(nc), nc_p, "port trace_rays vs Pallas kernel (interpret)")


@pytest.mark.parametrize("name", CASES)
def test_trace_lanes_plain_matches_jax(name):
    (L_x, nc_x), (L_p, nc_p) = _jax_results(name)
    med, prm, bb, o, d, pids, stream = _port(name)
    sf, si = tmk.pack_state(tint.init_state(med, o, d, prm))
    streams = tint.lane_streams(stream, N, o.device)
    sf, si = tmk.trace_lanes_plain(med, prm, bb, sf, si, pids, streams, prm.max_iters)
    L = sf[10:13].T.numpy()
    nc = int((si[1] != tint.DONE).sum())
    _assert_statistic(L, L_x, nc, nc_x, "kernel's plain version vs JAX trace_rays")
    _assert_statistic(L, L_p, nc, nc_p, "kernel's plain version vs Pallas kernel (interpret)")


def test_lane_loop_equals_compacted_wavefront():
    """Per-lane counters make a full-width lane loop (every lane every
    iteration, as the kernel runs them) and the compacted wavefront of the
    plain loop the same computation: bitwise equal radiance and counts."""
    med, prm, bb, o, d, pids, stream = _port("fog_sphere")
    step = tint.make_step(med, prm, bb)
    st = tint.init_state(med, o, d, prm)
    streams = tint.lane_streams(stream, N, o.device)
    for _ in range(prm.max_iters):
        active = st.mode != tint.DONE
        if not bool(active.any()):
            break
        nxt = step(st, trng.counter_uniforms(pids, streams, st.ctr, 4))
        st = nxt._replace(ctr=torch.where(active, nxt.ctr, st.ctr))
    L_b, it_b, nc_b = tmk.trace_rays_fused(med, prm, bb, o, d, pids, stream)  # CPU -> plain version
    assert torch.equal(st.L, L_b)
    assert int(st.ctr.max()) == int(it_b) and int((st.mode != tint.DONE).sum()) == int(nc_b)
    L_c, it_c, nc_c = tint.trace_rays(med, prm, bb, o, d, pids, stream)
    assert torch.equal(L_c, L_b) and int(it_c) == int(it_b) and int(nc_c) == int(nc_b)


def test_max_steps_splits_the_lane_loop():
    """k steps then the rest equals one run: the lane loop resumes exactly,
    and a DONE lane takes no step and keeps its counter."""
    med, prm, bb, o, d, pids, stream = _port("fire_plume_8wide")
    sf, si = tmk.pack_state(tint.init_state(med, o, d, prm))
    streams = tint.lane_streams(stream, N, o.device)
    whole = tmk.trace_lanes_plain(med, prm, bb, sf, si, pids, streams, prm.max_iters)
    part = tmk.trace_lanes_plain(med, prm, bb, sf, si, pids, streams, 7)
    assert int(part[1][2].max()) == 7
    rest = tmk.trace_lanes_plain(med, prm, bb, *part, pids, streams, prm.max_iters)
    assert torch.equal(whole[0], rest[0]) and torch.equal(whole[1], rest[1])
    again = tmk.trace_lanes_plain(med, prm, bb, *whole, pids, streams, 5)
    assert torch.equal(again[1], whole[1])


def test_iteration_cap_counts_capped_lanes():
    """At the cap, both tracers count every lane still alive."""
    med, prm, bb, o, d, pids, stream = _port("fog_sphere")
    prm_cap = tint.IntegratorParams(**dict(FOG, max_iters=6))
    _, it, nc = tint.trace_rays(med, prm_cap, bb, o, d, pids, stream)
    _, it_f, nc_f = tmk.trace_rays_fused(med, prm_cap, bb, o, d, pids, stream)
    assert int(it) == int(it_f) == 6
    assert int(nc) == int(nc_f) > 0


def test_trace_lanes_dispatch_by_device():
    """CPU tensors run the plain version; other devices are refused (a CUDA
    tensor launches the kernel, which the card-side run checks)."""
    med, prm, bb, o, d, pids, stream = _port("fog_sphere")
    sf, si = tmk.pack_state(tint.init_state(med, o, d, prm))
    streams = tint.lane_streams(stream, N, o.device)
    launches, plain = tmk.LAUNCHES, tmk.PLAIN_LAUNCHES
    tmk.trace_lanes(med, prm, bb, sf, si, pids, streams, 1)
    assert (tmk.LAUNCHES, tmk.PLAIN_LAUNCHES) == (launches, plain + 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tmk.trace_lanes(med, prm, bb, sf.to("meta"), si.to("meta"), pids, streams, 1)


def test_kernel_source_is_built_from_the_checkout():
    """The wrapper compiles the repository's own source for sm_90a (the CPU
    run checks the command line, not the compiler)."""
    import os

    assert os.path.isfile(tmk.SOURCE)
    with open(tmk.SOURCE) as f:
        source = f.read()
    for entry, kernel in (("vpt_render_wave", "render_wave_kernel"), ("vpt_trace_lanes", "trace_lanes_kernel")):
        assert f"int {entry}(" in source and f" {kernel}(const Args a)" in source
    assert "arch=compute_90a,code=sm_90a" in tmk.NVCC_FLAGS
    assert "--use_fast_math" not in tmk.NVCC_FLAGS
    assert tmk.BUILD_DIR.endswith(os.path.join("volume_path_tracer_tpu_torch", "_build"))
