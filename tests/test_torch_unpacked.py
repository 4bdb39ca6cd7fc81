"""The unpacked medium (Medium.from_grids(pack=False)) in the port, on the CPU.

A medium without the fused row table reads the dense density array (8
corners, each 0 outside the array), the (brick, superbrick) majorant pairs
and the dense temperature array through its own transform. On a card that
is the dense instantiation of the lane kernels (csrc/trace_lanes.cu,
kDense); here it is make_traversal's generic arm, their plain version. Held:

- the port's traversal and step on an unpacked medium against the JAX
  make_traversal / make_step on the same mid-flight state and the same
  uniforms, at the tolerances tests/test_torch_integrator.py holds the packed
  arm to (rtol=1e-5, atol=1e-6 on more than 99% of lanes: log1p differs in
  the last ulp between XLA and torch, and the port's step takes its
  quotients by the majorant through one reciprocal);
- render_wave_plain and trace_lanes_plain, unpacked against packed: bitwise.
  It holds because a packed row is the same 8 corners, zero-padded, and both
  arms sum them in dot8's order. The misaligned fire plume reads its
  temperature through the same transform in both; the aligned plume, packed,
  carries it in the 16-wide row in the density grid's frame, and is bitwise
  equal too, since its transform (zero world offset, integer index offset)
  is exact in float32;
- trace_rays unpacked against the JAX trace_rays on its unpacked medium by
  the statistic of tests/test_megakernel.py:50-53 (more than 95% of lanes
  close at rtol=1e-4, atol=1e-5, channel means within 5%), equal n_capped;
  fog and the emissive plume;
- what the wrapper gives the dense kernels: KernelConstants.dense and the
  third I_EMISSION value in the parameter layout that
  tests/test_torch_wave_kernel.py holds to the enums of the CUDA source, the
  tap layout, the refusal of arrays of 2^31 voxels, and the dense
  instantiations in the source (read as text: no compiler here).
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
from volume_path_tracer_tpu.utils import rng as jrng
from volume_path_tracer_tpu.utils import spectral as jspec
from volume_path_tracer_tpu_torch.models.camera import Camera
from volume_path_tracer_tpu_torch.models.medium import medium_from_numpy
from volume_path_tracer_tpu_torch.render import integrator as tint
from volume_path_tracer_tpu_torch.render import megakernel as tmk
from volume_path_tracer_tpu_torch.utils import rng as trng
from volume_path_tracer_tpu_torch.utils.config import CameraParameters

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
CASES = ["fog_sphere", "fire_plume"]
N = 1024


@functools.lru_cache(maxsize=None)
def _case(name):
    rng = np.random.default_rng(0)
    if name == "fog_sphere":
        jd, jt, prm, bb = jproc.fog_sphere(12.0, 3.0), None, FOG, None
        o = np.stack([np.full(N, -40.0), rng.uniform(-14, 14, N), rng.uniform(-14, 14, N)], -1)
    else:
        jd, jt = jproc.fire_plume(height=40, radius=10.0)
        if name == "fire_plume_aligned":
            jt = jgrid.dense_grid_from_array(np.asarray(jt.data), jt.origin_ijk, jt.voxel_size, (0.0, 0.0, 0.0))
        prm, bb = FIRE, jspec.blackbody_xyz_table()
        o = np.stack([np.full(N, -40.0), rng.uniform(5, 35, N), rng.uniform(-10, 10, N)], -1)
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (N, 1))
    return dict(jd=jd, jt=jt, prm=prm, bb=bb, o=o.astype(np.float32), d=d,
                pids=np.arange(N, dtype=np.int32), seed=(3, 1))


def _jax(name):
    c = _case(name)
    med = JMedium.from_grids(c["jd"], c["jt"], pack=False)
    assert med.density_rows is None
    prm = jint.IntegratorParams(**c["prm"])
    bb = None if c["bb"] is None else jnp.asarray(c["bb"])
    return med, prm, bb, jnp.asarray(c["o"]), jnp.asarray(c["d"]), jnp.asarray(c["pids"]), \
        jrng.mix_stream(*c["seed"])


def _port(name, pack=False):
    c = _case(name)
    med = medium_from_numpy(c["jd"], c["jt"], device="cpu", pack=pack)
    assert (med.density_rows is None) == (not pack)
    prm = tint.IntegratorParams(**c["prm"])
    bb = None if c["bb"] is None else torch.from_numpy(c["bb"])
    return med, prm, bb, torch.from_numpy(c["o"]), torch.from_numpy(c["d"]), torch.from_numpy(c["pids"]), \
        trng.mix_stream(*c["seed"])


@functools.lru_cache(maxsize=None)
def _mid_flight(name):
    """A JAX state 12 steps in, and the next step's uniforms (numpy)."""
    med, prm, bb, o, d, pids, stream = _jax(name)
    step = jint.make_step(med, prm, bb)
    st = jint.init_state(med, o, d, prm)
    for _ in range(12):
        st = step(st, jrng.counter_uniforms(pids, stream, st.ctr, 4))
    return st, np.array(jrng.counter_uniforms(pids, stream, st.ctr, 4))


def _to_port(st) -> tint.RayState:
    return tint.RayState(*(torch.from_numpy(np.array(x)) for x in st))


def _agree(pairs):
    """Per-lane agreement over (name, jax array, torch tensor) triples."""
    ok = np.ones(N, bool)
    for field, a, b in pairs:
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, field
        lane = np.isclose(a, b, rtol=1e-5, atol=1e-6) if a.dtype == np.float32 else a == b
        ok &= lane.reshape(N, -1).all(-1)
    return ok


@pytest.mark.parametrize("name", CASES)
def test_traversal_unpacked_matches_jax(name):
    st, u = _mid_flight(name)
    jmed, jprm, *_ = _jax(name)
    active = st.mode != jint.DONE
    jtr = jint.make_traversal(jmed, jprm)(st.o, st.d, st.t, st.t_exit, st.sig_seg, st.t_seg, active,
                                          jnp.asarray(u[:, 0]))
    med, prm, *_ = _port(name)
    ts = _to_port(st)
    ttr = tint.make_traversal(med, prm)(ts.o, ts.d, ts.t, ts.t_exit, ts.sig_seg, ts.t_seg,
                                        ts.mode != tint.DONE, torch.from_numpy(u[:, 0]))
    fields = ["collide", "exited", "fetch", "t_cand", "t_next", "p_col", "rho", "sigma_maj", "sig_seg_f",
              "t_seg_f", "use_super", "cell_lo", "cell_sz", "real_col", "zero_col"]
    ok = _agree((f, getattr(jtr, f), getattr(ttr, f)) for f in fields)
    assert ttr.temp_adim is None and jtr.temp_adim is None
    assert np.asarray(jtr.collide).any() and np.asarray(jtr.fetch).any()
    assert ok.mean() > 0.99, ok.mean()


@pytest.mark.parametrize("name", CASES)
def test_make_step_unpacked_matches_jax(name):
    st, u = _mid_flight(name)
    jmed, jprm, jbb, *_ = _jax(name)
    j_next = jint.make_step(jmed, jprm, jbb)(st, jnp.asarray(u))
    med, prm, bb, *_ = _port(name)
    t_next = tint.make_step(med, prm, bb)(_to_port(st), torch.from_numpy(u))
    for a, b in zip(j_next, t_next):
        assert np.asarray(a).dtype == b.numpy().dtype
    ok = _agree(zip(tint.RayState._fields, j_next, t_next))
    modes = np.asarray(st.mode)
    assert (modes == jint.SHADOW).any() and (modes == jint.CAM).any()
    assert ok.mean() > 0.99, ok.mean()


def _camera(name):
    p = (CameraParameters((45.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 40.0, 0.1) if name == "fog_sphere"
         else CameraParameters((60.0, 20.0, 0.0), (0.0, 20.0, 0.0), (0.0, 1.0, 0.0), 40.0, 0.1))
    return Camera.from_parameters(p, (32, 24), device="cpu")


@pytest.mark.parametrize("name", CASES + ["fire_plume_aligned"])
def test_render_wave_plain_unpacked_equals_packed_bitwise(name):
    cam = _camera(name)
    films = []
    for pack in (False, True):
        med, prm, bb, *_ = _port(name, pack)
        film = torch.zeros((24, 32, 4))
        iters, ncap = tmk.render_wave(med, prm, cam, bb, film, range(0, 32 * 24), trng.mix_stream(10, 1),
                                      True, 0.1)
        films.append((film, int(iters), int(ncap)))
        if pack:
            assert med.density_rows.shape[1] == (16 if name == "fire_plume_aligned" else 8)
    assert torch.equal(films[0][0], films[1][0])
    assert films[0][1:] == films[1][1:] and films[0][2] == 0
    assert (films[0][0][..., 3] == 1).all() and films[0][0][..., :3].max() > 0


@pytest.mark.parametrize("name", CASES + ["fire_plume_aligned"])
def test_trace_lanes_plain_unpacked_equals_packed_bitwise(name):
    out = []
    for pack in (False, True):
        med, prm, bb, o, d, pids, stream = _port(name, pack)
        sf, si = tmk.pack_state(tint.init_state(med, o, d, prm))
        out.append(tmk.trace_lanes(med, prm, bb, sf, si, pids, tint.lane_streams(stream, N, o.device),
                                   prm.max_iters))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert int((out[0][1][1] != tint.DONE).sum()) == 0


@pytest.mark.parametrize("name", CASES)
def test_trace_rays_unpacked_matches_jax(name):
    L_j, _, nc_j = jint.trace_rays(*_jax(name))
    L_j = np.asarray(L_j)
    for tracer in (tint.trace_rays, tmk.trace_rays_fused):
        L, it, nc = tracer(*_port(name))
        L = L.numpy()
        assert int(it) > 0
        close = np.isclose(L, L_j, rtol=1e-4, atol=1e-5).all(-1).mean()
        assert close > 0.95, (tracer.__name__, close)
        rel = np.abs(L.mean(0) - L_j.mean(0)) / (np.abs(L_j.mean(0)) + 1e-9)
        assert (rel < 0.05).all(), (tracer.__name__, rel)
        assert int(nc) == int(nc_j) == 0
    if name == "fire_plume":
        # the plume emits: without the temperature grid the radiance differs
        c = _case(name)
        med0 = medium_from_numpy(c["jd"], None, device="cpu", pack=False)
        L0, _, _ = tint.trace_rays(med0, *_port(name)[1:])
        assert not np.allclose(L0.numpy(), L, rtol=1e-3)


def test_emissive_unpacked_samples_the_temperature_array_through_its_own_transform():
    med, prm, _, *_ = _port("fire_plume")
    jmed, jprm, *_ = _jax("fire_plume")
    assert med.temperature_rows is None and med.temperature.world_offset != med.density.world_offset
    rng = np.random.default_rng(4)
    X, Y, Z = med.density.shape
    # points over the box and two voxels beyond it on every side
    p = rng.uniform(0, 1, (500, 3)) * np.array([X + 4, Y + 4, Z + 4]) - 2
    p = (p + np.asarray(med.density.origin_ijk)).astype(np.float32)
    t_k = tint.sample_temperature_kelvin(med, prm, torch.from_numpy(p)).numpy()
    j_k, _ = jint.sample_temperature_kelvin(jmed, jprm, jnp.asarray(p))
    np.testing.assert_allclose(t_k, np.asarray(j_k), rtol=1e-6, atol=1e-4)  # kelvin: an ulp at 2000 K is 1.2e-4
    assert t_k.max() > prm.temperature_offset + 100


# ------------------------------------------------- what the kernels are given


@pytest.mark.parametrize("name, emission", [("fog_sphere", 0), ("fire_plume", 3)])
def test_constants_of_an_unpacked_medium(name, emission):
    med, prm, bb, *_ = _port(name)
    cam = _camera(name)
    k = tmk.kernel_constants(med, prm, bb, cam, 32, True, 0.1)
    assert k.dense and k.emission == emission
    assert (k.pairs is not None) == (emission != 0)
    packed = tmk.kernel_constants(_port(name, True)[0], prm, bb, cam, 32, True, 0.1)
    assert not packed.dense and packed.emission == (2 if emission else 0)
    # The layout is the packed medium's (tests/test_torch_wave_kernel.py holds
    # it to the enums of the CUDA source); what differs is the emission arm.
    n_pairs = 0 if k.pairs is None else k.pairs.shape[0]
    fields = tmk._param_fields(med, prm, n_pairs, emission, cam, 32, True, 0.1)
    at, size = tmk.param_layout(fields[1])
    assert size == k.ip.size == packed.ip.size and tmk.param_layout(fields[0])[1] == k.fp.size
    ip = {name: int(k.ip[i]) for name, i in at.items()}
    assert ip["I_EMISSION"] == emission
    assert (ip["I_X"], ip["I_Y"], ip["I_Z"]) == tuple(med.density.shape)
    assert (ip["I_BX"], ip["I_BY"], ip["I_BZ"]) == tuple(med.majorants.brick_maj.shape)
    if emission:
        assert (ip["I_TX"], ip["I_TY"], ip["I_TZ"]) == tuple(med.temperature.shape)
    differ = [name for name, i in at.items() if k.ip[i] != packed.ip[i]]
    assert differ == (["I_EMISSION"] if emission else [])
    with open(tmk.SOURCE) as f:
        assert "// 3 (dense instantiations) temperature from its dense array" in f.read()
    # the float parameters do not depend on the packing
    np.testing.assert_array_equal(k.fp, packed.fp)


@pytest.mark.parametrize("name", CASES)
def test_tap_layout_counts_sectors_pairs_and_rows(name):
    med, prm, bb, *_ = _port(name)
    emission = tmk.kernel_constants(med, prm, bb).emission
    layout = tmk.tap_layout(med, emission)
    n_vox = med.density.data.numel()
    assert layout[0] == ("density sectors", -(-n_vox // 8), 32)
    assert layout[1] == ("majorant pairs", med.majorants.rows.shape[0], 8)
    assert len(layout) == (3 if emission else 2)
    if emission:
        assert layout[2] == ("temperature sectors", -(-med.temperature.data.numel() // 8), 32)
    tap = tmk.new_row_tap(med, prm, bb)
    assert tap.dtype == torch.uint8 and tap.shape[0] == sum(n for _, n, _ in layout)
    tap[0] = tap[1] = 1
    tap[layout[0][1]] = 1
    got = tmk.read_row_tap(med, prm, bb, tap)
    assert got[0] == ("density sectors", 2, layout[0][1], 64) and got[1][1:] == (1, layout[1][1], 8)
    pmed = _port(name, True)[0]
    p_layout = tmk.tap_layout(pmed, tmk.kernel_constants(pmed, prm, bb).emission)
    assert p_layout[0] == ("rows", pmed.density_rows.shape[0], 32)
    assert [x[0] for x in p_layout[1:]] == (["temperature rows"] if emission else [])


def test_dense_arrays_of_2_to_31_voxels_are_refused():
    """By the gradient launches only: the forward launches' fetch makes its
    offsets in 64 bits and takes arrays of 2^31 voxels or more."""
    big = torch.empty((2048, 1024, 1024), dtype=torch.float32, device="meta")
    huge = torch.empty((1300, 1300, 1300), dtype=torch.float32, device="meta")
    for arr in (big, huge):
        tmk._check_dense(arr, arr.shape, "the density array", arr.device)
        with pytest.raises(ValueError, match="a gradient launch takes dense arrays of fewer than 2\\^31 voxels"):
            tmk._check_dense(arr, arr.shape, "the density array", arr.device, gradient=True)
    ok = torch.empty((2047, 1024, 1024), dtype=torch.float32, device="meta")
    tmk._check_dense(ok, ok.shape, "the density array", ok.device)
    tmk._check_dense(ok, ok.shape, "the density array", ok.device, gradient=True)
    for gradient in (False, True):
        with pytest.raises(ValueError, match="contiguous float32"):
            tmk._check_dense(ok.to(torch.float16), ok.shape, "the density array", ok.device, gradient)
        with pytest.raises(ValueError, match="contiguous float32"):
            tmk._check_dense(big.to(torch.float16), big.shape, "the density array", big.device, gradient)


def test_kernel_source_has_the_dense_instantiations():
    with open(tmk.SOURCE) as f:
        source = f.read()
    # kDense: 0 reads the fused table, 1 the grids' own arrays; no other form
    assert "template <bool kTap, int kDense>" in source and "DenseForm" not in source
    assert "return dense ? pick_kernel<1>(kind, tap) : pick_kernel<0>(kind, tap);" in source
    assert "static int resident[MAX_DEVICES][kNumKinds][2][2];" in source
    assert "render_wave_kernel<true, kDense, false>" in source and "render_wave_kernel<false, kDense, false>" in source
    # and the counting wave (return_lane_iters), which has no measuring twin
    assert "render_wave_kernel<false, kDense, true>" in source and "render_wave_kernel<true, kDense, true>" not in source
    assert "trace_lanes_kernel<true, kDense, false>" in source and "trace_lanes_kernel<false, kDense, false>" in source
    # the record and replay kernels of the gradient path have theirs too,
    # each with its measuring twin
    assert "trace_lanes_kernel<false, kDense, true>" in source and "trace_lanes_kernel<true, kDense, true>" in source
    assert "replay_lanes_kernel<false, kDense>" in source and "replay_lanes_kernel<true, kDense>" in source
    # the dense arm is chosen at compile time, not by a branch in the step,
    # for density and temperature alike
    assert source.count("if constexpr (kDense != 0)") == 2
    assert "dense_trilinear<kTap, kWide>(a.dens" in source and "dense_trilinear<kTap, kWide>(a.tdata" in source
    # the launch refuses a dense or temperature array that is not its grid's
    # voxel count, the only length the kernels index by
    assert "if (a.n_dens != (long long)ip[I_X] * ip[I_Y] * ip[I_Z]) return (int)cudaErrorInvalidValue;" in source
    assert "ip[I_EMISSION] == 3 && a.n_tdata != (long long)ip[I_TX] * ip[I_TY] * ip[I_TZ]" in source
    # dot8 spells out the fusion order that dense_trilinear's sum compiles to
    assert source.count("__fmaf_rn(a.x, w[0], __fmul_rn(a.y, w[1]))") == 1
    assert "float s = v[0] * w[0];" in source
    # the C interface carries the three new arrays to all five launches
    # (and through set_tables and launch_wave), their lengths in 64 bits
    assert source.count("const float* dens, long long n_dens, const float* maj, int n_maj") == 7
    assert source.count("const float* tdata, long long n_tdata") == 7
    assert "int n_dens" not in source and "int n_tdata" not in source
    # the forward kinds' fetch makes the base voxel's offset once, in 64
    # bits, and adds the corner strides to it; the gradient kinds' (arrays
    # under 2^31 voxels) keeps an int offset a corner
    assert "constexpr bool kWide = kKind != kRecordKind && kKind != kReplayKind;" in source
    assert "const long long base = kWide ? ((long long)ix * Y + iy) * Z + iz : 0;" in source
    assert "const long long flat = base + ((c >> 2) ? yz : 0) + (((c >> 1) & 1) ? Z : 0) + (c & 1);" in source
    assert "const int flat = (cx * Y + cy) * Z + cz;" in source
    assert source.count("lane_step<kTap, kDense, kWide>(L, a);") == 2
    assert "traverse<kTap, kDense, false>(L, a, tr);" in source
