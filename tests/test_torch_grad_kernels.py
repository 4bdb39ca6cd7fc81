"""The gradient path's two kernel wrappers on the CPU: record_lanes and
replay_lanes as the lanes-born-from-rays design calls them.

On a card record_lanes makes each lane from its world ray inside the kernel
and hands back (radiance, residuals, last counters); replay_lanes takes the
lanes in a queue order built from those counters (groups of neighbouring
lanes, the longest group first). Here, on
CPU tensors, both run their plain versions, and what the kernels rely on is
held:

- record_lanes returns the plain record loop's radiance and residuals bitwise
  (diff/prb.py _trace_rays_record, itself held to the JAX package by
  tests/test_torch_prb.py) and the plain loop's final counters; its radiance
  against the JAX package's _trace_rays_record by the statistic of
  tests/test_torch_integrator.py (log1p and the step's quotients differ in
  the last bit between the packages and flip knife-edge events on a few
  lanes);
- a queue order changes no lane's replay: each lane's replayed <g, L> is
  bitwise the same under a permutation, and the gradient grids agree within
  relative L2 1e-5 (index_add_ sums in another order);
- trace_rays_prb with k_walks = 0 now records (no slots) to have the
  counters, and feeds the replay bitwise the gradients of the earlier
  composition (trace_rays_fused, then replay_grads without residuals);
- the constants of launches without a camera are keyed by what they are made
  of, so two steps' media share one entry and another geometry does not;
- the C interface: every vpt_* function of the source's extern "C" block
  against the ctypes table the library is bound by.
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_path_tracer_tpu.diff import prb as jprb
from volume_path_tracer_tpu.grids import grid as jgrid
from volume_path_tracer_tpu.grids import majorant as jmaj
from volume_path_tracer_tpu.models import medium as jmed
from volume_path_tracer_tpu.render import integrator as jint
from volume_path_tracer_tpu_torch.diff import inverse as tinv
from volume_path_tracer_tpu_torch.diff import prb as tprb
from volume_path_tracer_tpu_torch.grids import grid as tgrid
from volume_path_tracer_tpu_torch.grids import majorant as tmaj
from volume_path_tracer_tpu_torch.grids import procedural as tproc
from volume_path_tracer_tpu_torch.models import medium as tmed
from volume_path_tracer_tpu_torch.render import integrator as tint
from volume_path_tracer_tpu_torch.render import megakernel as tmk
from volume_path_tracer_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

# Scattering with NEE over an 8^3 grid (tests/test_torch_prb.py's "nee" case).
PARAMS = dict(
    sigma_a=0.1, sigma_s=0.6, hg_g=0.4, le_scale=0.0,
    temperature_offset=300.0, temperature_scale=40.0,
    infinite_xyz=(1.0, 1.0, 1.0), infinite_multiplier=0.3,
    distant_xyz=(0.95, 1.0, 1.09), distant_multiplier=5.0, distant_inv_direction=(0.3, 0.8, 0.2),
    max_depth=40, max_iters=128,
)
N = 512
STREAM = (7, 2)


def _inputs(n=N, seed=3):
    """(rho [8, 8, 8], o, d [n, 3], pids [n], the per-lane streams [n] of two
    waves, cotangent [n, 3]) as numpy, from one seed."""
    rng = np.random.default_rng(seed)
    rho = (0.5 * (0.75 + 0.5 * rng.random((8, 8, 8)))).astype(np.float32)
    o = np.stack([np.full(n, -3.0), rng.uniform(-1.0, 9.0, n), rng.uniform(-1.0, 9.0, n)], -1).astype(np.float32)
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    pids = np.arange(n, dtype=np.int32) % (n // 2)
    streams = np.repeat([trng.mix_stream(*STREAM), trng.mix_stream(STREAM[0], STREAM[1] + 1)], n // 2)
    g = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    return rho, o, d, pids, streams.astype(np.int64), g


def _port(rho, pack=False):
    g = tgrid.dense_grid_from_array(rho)
    maj = tmaj.build_majorants(g, bloat=0.2)
    return tmed.Medium(density=g, majorants=maj, temperature=None,
                       density_rows=tmed.pack_fused_rows(g.data, maj) if pack else None)


def _case(pack=False, **kw):
    rho, o, d, pids, streams, g = _inputs()
    prm = tint.IntegratorParams(**dict(PARAMS, **kw))
    rays = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(pids), torch.from_numpy(streams))
    return _port(torch.from_numpy(rho), pack), prm, rays, torch.from_numpy(g), rho


@pytest.mark.parametrize("k_walks", [8, 0], ids=["slots", "no_slots"])
@pytest.mark.parametrize("pack", [False, True], ids=["dense", "packed"])
def test_record_lanes_on_cpu_returns_the_plain_loops_outputs(k_walks, pack):
    med, prm, rays, _, _ = _case(pack)
    before = (tmk.PLAIN_RECORD_LAUNCHES, tmk.RECORD_LAUNCHES)
    L, tf, ctr = tmk.record_lanes(med, prm, None, *rays, k_walks)
    assert (tmk.PLAIN_RECORD_LAUNCHES, tmk.RECORD_LAUNCHES) == (before[0] + 1, before[1])
    L_ref, tf_ref = tprb._trace_rays_record(med, prm, None, *rays, k_walks)
    assert torch.equal(L, L_ref) and torch.equal(tf, tf_ref) and tf.shape == (N, k_walks)
    # the counters are the plain loop's final state (trace_lanes_plain from
    # init_state), as the record kernel's are trace_lanes_kernel's
    sf, si = tmk.pack_state(tint.init_state(med, rays[0], rays[1], prm))
    sf_t, si_t = tmk.trace_lanes_plain(med, prm, None, sf, si, rays[2], rays[3], prm.max_iters)
    assert ctr.dtype == torch.int32 and torch.equal(ctr, si_t[2])
    assert torch.equal(L, sf_t[10:13].T)
    hit = si[1] == tint.CAM
    assert bool((ctr[hit] > 0).all()) and bool((ctr[~hit] == 0).all()) and bool((~hit).any())
    if k_walks:
        assert bool((tf != 0).any())


def test_record_radiance_matches_the_jax_record():
    rho, o, d, pids, streams, _ = _inputs()
    med, prm, rays, _, _ = _case()
    L, tf, _ = tmk.record_lanes(med, prm, None, *rays, 8)
    jg = jgrid.dense_grid_from_array(jnp.asarray(rho))
    jm = jmed.Medium(density=jg, majorants=jmaj.build_majorants(jg, bloat=0.2), temperature=None)
    jL, jtf = jprb._trace_rays_record(jm, jint.IntegratorParams(**PARAMS), None, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(pids), jnp.asarray(streams.astype(np.uint32)), 8)
    close = np.isclose(L.numpy(), np.asarray(jL), rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() > 0.95, close.mean()
    # where the lanes agree, so do their recorded walks
    np.testing.assert_allclose(tf.numpy()[close], np.asarray(jtf)[close], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("k_walks", [8, 0], ids=["recorded", "pre_grad"])
def test_a_queue_order_changes_no_lanes_replay(k_walks):
    """The plain replay with its lanes permuted by a queue order and the
    per-lane sums put back: every lane's replayed <g, L> is bitwise the
    unpermuted run's; the gradient grids sum in another order."""
    med, prm, rays, g, _ = _case()
    L, tf, ctr = tmk.record_lanes(med, prm, None, *rays, k_walks)
    tf = tf if k_walks else None
    dd, _, acc, tot = tmk.replay_lanes(med, prm, None, *rays, L, g, tf=tf, with_check=True)
    perm = torch.from_numpy(np.random.default_rng(9).permutation(N).astype(np.int32))
    for order in (perm, tmk.longest_first(ctr)):
        before = tmk.PLAIN_REPLAY_LAUNCHES
        dd_o, _, acc_o, tot_o = tmk.replay_lanes(med, prm, None, *rays, L, g, tf=tf, with_check=True, order=order)
        assert tmk.PLAIN_REPLAY_LAUNCHES == before + 1
        assert torch.equal(acc_o, acc) and torch.equal(tot_o, tot)
        assert float(dd.abs().max()) > 0
        rel = float((dd_o.double() - dd.double()).norm() / dd.double().norm())
        assert rel <= 1e-5, rel
        dd_plain = tmk.replay_lanes(med, prm, None, *rays, L, g, tf=tf, order=order)[0]
        assert torch.equal(dd_plain, dd_o)
    np.testing.assert_allclose(acc.numpy(), tot.numpy(), rtol=1e-5, atol=1e-5)


def test_longest_first_orders_groups_by_their_longest_lane():
    ctr = torch.tensor([3, 0, 17, 5, 17, 1, 2], dtype=torch.int32)
    # groups of 2 (the last one short): the groups by their longest lane,
    # ties in index order, the lanes of a group in index order
    order = tmk.longest_first(ctr, group=2)
    assert order.dtype == torch.int32 and order.tolist() == [2, 3, 4, 5, 0, 1, 6]
    # groups of 1: the lanes themselves, longest first
    assert ctr[tmk.longest_first(ctr, group=1).long()].tolist() == [17, 17, 5, 3, 2, 1, 0]
    big = torch.from_numpy(np.random.default_rng(4).integers(0, 300, 5000).astype(np.int32))
    order = tmk.longest_first(big)
    assert sorted(order.tolist()) == list(range(5000))
    tops = [int(big[order[i:i + tmk.QUEUE_GROUP].long()].max()) for i in range(0, 5000, tmk.QUEUE_GROUP)]
    assert tops == sorted(tops, reverse=True)
    assert tmk.longest_first(torch.zeros(0, dtype=torch.int32)).shape == (0,)


def test_k_walks_zero_feeds_the_replay_the_same_gradients():
    """With k_walks = 0 a gradient-wanting forward goes through record_lanes
    (no slots) for its counters; the replay then gives bitwise the gradient
    of the earlier composition: trace_rays_fused forward, replay_grads with
    every walk PRE+GRAD."""
    med, prm, rays, g, rho = _case()
    r = torch.tensor(rho, requires_grad=True)
    before = tmk.PLAIN_RECORD_LAUNCHES
    L = tprb.trace_rays_prb(_port(r), prm, None, *rays, k_walks=0)
    assert tmk.PLAIN_RECORD_LAUNCHES == before + 1
    (L * g).sum().backward()
    L_old, _, _ = tmk.trace_rays_fused(med, prm, None, *rays)
    dd_old, _ = tprb.replay_grads(med, prm, None, *rays, L_old, g, tf=None)
    assert torch.equal(L.detach(), L_old)
    assert float(dd_old.abs().max()) > 0 and torch.equal(r.grad, dd_old)


def test_no_nee_records_no_walks():
    """Without NEE there are no walks: the forward records with no slots and
    the replay takes no residuals, whatever k_walks asks."""
    med, prm, rays, g, rho = _case(distant_multiplier=0.0)
    assert not prm.nee_enabled
    r = torch.tensor(rho, requires_grad=True)
    L = tprb.trace_rays_prb(_port(r), prm, None, *rays, k_walks=8)
    (L * g).sum().backward()
    dd, _ = tprb.replay_grads(med, prm, None, *rays, L.detach(), g, tf=None)
    assert torch.equal(r.grad, dd) and float(dd.abs().max()) > 0


def test_stream_words_as_int32_bits():
    """The wrappers' one-launch stream conversion: an int64 tensor's low
    words, an int32 tensor as it is, one word filled, each equal to
    _as_i32_bits of integrator.lane_streams."""
    n = 6
    words = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 123456789]
    want = tmk._as_i32_bits(tint.lane_streams(torch.tensor(words, dtype=torch.int64), n, "cpu"))
    assert torch.equal(tmk._stream_bits(torch.tensor(words, dtype=torch.int64), n, torch.device("cpu")), want)
    assert torch.equal(tmk._stream_bits(want, n, torch.device("cpu")), want)
    for w in (5, 2**31 + 7, 2**32 - 1):
        got = tmk._stream_bits(w, n, torch.device("cpu"))
        assert got.dtype == torch.int32 and torch.equal(got, tmk._as_i32_bits(tint.lane_streams(w, n, "cpu")))


def test_gradient_wrappers_refuse_other_devices():
    med, prm, rays, g, _ = _case()
    meta = tuple(x.to("meta") for x in rays)
    with pytest.raises(ValueError, match="unsupported device"):
        tmk.record_lanes(med, prm, None, *meta, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tmk.replay_lanes(med, prm, None, *meta, g.to("meta"), g.to("meta"), order=torch.zeros(N, device="meta"))


# ---------------------------------------------------------- constants ----

def _step_medium(base, seed, pack=False, **kw):
    """The medium a train step builds (inverse.medium_with_params) from
    grids that differ every step."""
    p = tinv.param_from_density(base.density.data) + 0.01 * torch.from_numpy(
        np.random.default_rng(seed).standard_normal(base.density.shape).astype(np.float32))
    return tinv.medium_with_params(base, tinv.OptimizableGrids(p), pack=pack, **kw)


@pytest.mark.parametrize("pack", [False, True], ids=["dense", "packed"])
def test_geometry_keyed_constants_are_shared_across_steps(pack):
    base = tmed.Medium.from_grids(tproc.fog_sphere(radius=6.0, falloff=2.0), pack=False, device="cpu")
    prm = tint.IntegratorParams(**PARAMS)
    m1, m2 = _step_medium(base, 1, pack), _step_medium(base, 2, pack)
    assert not torch.equal(m1.density.data, m2.density.data)
    a = tmk.kernel_constants(m1, prm, None)
    b = tmk.kernel_constants(m2, prm, None)
    assert b is a and a.dense == (not pack)
    # what the constants are made of: another shape, voxel size or params
    # makes another entry
    other_shape = tmed.Medium.from_grids(tproc.fog_sphere(radius=7.0, falloff=2.0), pack=pack, device="cpu")
    other_voxel = tmed.Medium.from_grids(tproc.fog_sphere(radius=6.0, falloff=2.0, voxel_size=0.5), pack=pack,
                                         device="cpu")
    for c in (tmk.kernel_constants(other_shape, prm, None), tmk.kernel_constants(other_voxel, prm, None),
              tmk.kernel_constants(m1, dataclasses.replace(prm, sigma_s=0.5), None)):
        assert c is not a and c.scratch is not a.scratch
    assert not np.array_equal(tmk.kernel_constants(other_voxel, prm, None).fp, a.fp)
    # a camera's launches keep their entries by identity
    sc_cam = tmk.Camera.from_numpy(np.array([20.0, 0.0, 0.0], np.float32), np.eye(3, dtype=np.float32),
                                   np.zeros(3, np.float32), 0.1, device="cpu")
    assert tmk.kernel_constants(m1, prm, None, sc_cam, 8, True, 0.1) is not a


def test_geometry_entries_are_bounded():
    prm = tint.IntegratorParams(**PARAMS)
    for r in range(tmk.GEOMETRY_ENTRIES + 4):
        tmk.kernel_constants(_port(torch.full((4 + r, 4, 4), 0.3)), prm, None)
    assert sum(1 for k in tmk._CONSTANTS if k[0] == "geometry") <= tmk.GEOMETRY_ENTRIES


def test_geometry_entries_still_check_the_medium():
    base = tmed.Medium.from_grids(tproc.fog_sphere(radius=6.0, falloff=2.0), pack=False, device="cpu")
    prm = tint.IntegratorParams(**PARAMS)
    good = _step_medium(base, 3, pack=True)
    tmk.kernel_constants(good, prm, None)
    bad = dataclasses.replace(good, density_rows=good.density_rows[:, :6].contiguous())
    with pytest.raises(ValueError, match="density_rows"):
        tmk.kernel_constants(bad, prm, None)


# ------------------------------------------------------- C interface ----

def _c_functions(source):
    """{name: (return kind, [parameter kinds])} of every vpt_* function
    defined in the source's extern "C" block; a kind is "pointer", "int",
    "unsigned" or "long long"."""
    block = source[source.index('extern "C" {'):]

    def kind(decl):
        decl = " ".join(decl.split())
        if "*" in decl:
            return "pointer"
        if decl.startswith("unsigned") or decl.startswith("uint32_t"):
            return "unsigned"
        if decl.startswith("long long "):
            return "long long"
        assert decl.startswith("int "), decl
        return "int"

    out = {}
    for m in re.finditer(r"^([\w ]+?\**)\s*(vpt_\w+)\(([^)]*)\)\s*\{", block, re.M):
        params = [p for p in m.group(3).split(",") if p.strip()]
        out[m.group(2)] = (kind(m.group(1) + " x"), [kind(p) for p in params])
    return out


def _ctypes_kind(t):
    import ctypes

    return {ctypes.c_void_p: "pointer", ctypes.c_char_p: "pointer", ctypes.c_int: "int",
            ctypes.c_uint: "unsigned", ctypes.c_longlong: "long long"}[t]


def test_c_signatures_match_the_kernel_source():
    with open(tmk.SOURCE) as f:
        declared = _c_functions(f.read())
    assert set(declared) == set(tmk.C_SIGNATURES)
    for name, (restype, argtypes) in tmk.C_SIGNATURES.items():
        ret, params = declared[name]
        assert _ctypes_kind(restype) == ret, name
        assert [_ctypes_kind(t) for t in argtypes] == params, name
    # the five launches end with the same table arguments
    for name in ("vpt_trace_lanes", "vpt_render_wave", "vpt_render_wave_counted", "vpt_record_lanes",
                 "vpt_replay_lanes"):
        assert tuple(tmk.C_SIGNATURES[name][1][-len(tmk._TABLES):]) == tmk._TABLES


def test_the_parser_sees_a_mismatch():
    """The guard itself: a pointer declared where the table has an int, or a
    parameter too many, shows."""
    src = 'extern "C" {\nint vpt_occupancy(int device, int* dense, int* a, int* b, int* c, int* d, int* e, int* f) {\n}\n}'
    ret, params = _c_functions(src)["vpt_occupancy"]
    assert ret == "int" and params[1] == "pointer"
    assert params != [_ctypes_kind(t) for t in tmk.C_SIGNATURES["vpt_occupancy"][1]]
    src2 = 'extern "C" {\nconst char* vpt_error_string(int err, unsigned int w) { return 0; }\n}'
    assert _c_functions(src2)["vpt_error_string"] == ("pointer", ["int", "unsigned"])
