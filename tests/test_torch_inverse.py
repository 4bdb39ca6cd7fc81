"""The port's inverse rendering (diff/inverse.py) against the JAX package.

softplus and its inverse, the per-step medium, the render loss (plain and
dual-buffer) on the same numpy inputs; torch.optim.Adam against optax.adam
with the same gradient fed to both (their update is the same function with
another rounding order: rtol 1e-5); train checkpoints written by one package
and read by the other, then one more step with the same gradient on both
sides; and one CPU train step through the plain path replay.

The loss renders paths: the port and the JAX package differ in the last bit
of log1p and of the step's quotients, which can flip a knife-edge event on a
rare lane (tests/test_torch_integrator.py), so the loss is held at rtol 1e-3.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from volume_path_tracer_tpu.diff import inverse as jinv
from volume_path_tracer_tpu.grids import procedural as jproc
from volume_path_tracer_tpu.models.camera import Camera as JCamera
from volume_path_tracer_tpu.models.medium import Medium as JMedium
from volume_path_tracer_tpu.render import integrator as jint
from volume_path_tracer_tpu.utils.config import CameraParameters
from volume_path_tracer_tpu.utils.spectral import blackbody_xyz_table
from volume_path_tracer_tpu_torch.diff import inverse as tinv
from volume_path_tracer_tpu_torch.models.camera import Camera
from volume_path_tracer_tpu_torch.models.medium import medium_from_numpy
from volume_path_tracer_tpu_torch.parallel.shard import make_mesh
from volume_path_tracer_tpu_torch.render import integrator as tint
from volume_path_tracer_tpu_torch.render import megakernel as tmk

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
    distant_inv_direction=(0.5, 1.0, 0.0), max_depth=10_000, max_iters=512,
)
W, H, K = 16, 12, 2
N_ITERS = 160


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(JAX base medium, params, camera, bb) and the port's, one numpy source."""
    if name == "fog":
        jd, jt, prm, bb = jproc.fog_sphere(radius=5.0, falloff=2.0), None, FOG, None
        cam = CameraParameters((20.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 40.0, 0.1)
    else:
        jd, jt = jproc.fire_plume(height=16, radius=4.0)
        prm, bb = FIRE, blackbody_xyz_table()
        cam = CameraParameters((30.0, 8.0, 0.0), (0.0, 8.0, 0.0), (0.0, 1.0, 0.0), 40.0, 0.1)
    jmed = JMedium.from_grids(jd, jt, pack=False)
    tmed = medium_from_numpy(jd, jt, device="cpu", pack=False)
    jcam = JCamera.from_parameters(cam, (W, H))
    tcam = Camera.from_numpy(jcam.position, jcam.raster_to_world_dir, jcam.raster_to_world_trans,
                             jcam.imaging_ratio, device="cpu")
    return (jmed, jint.IntegratorParams(**prm), jcam, None if bb is None else jnp.asarray(bb)), \
        (tmed, tint.IntegratorParams(**prm), tcam, None if bb is None else torch.from_numpy(bb))


def _batch():
    ys, xs = np.mgrid[0:H, 0:W]
    raster = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)
    pids = np.arange(W * H, dtype=np.int32)
    target = np.random.default_rng(3).uniform(0.0, 0.05, (W * H, 3)).astype(np.float32)
    return raster, pids, target


def _jgrids(jmed):
    t = jmed.temperature.data if jmed.temperature is not None else None
    return jinv.OptimizableGrids(log_density=jinv.param_from_density(jmed.density.data), temperature=t)


def _tgrids(tmed, requires_grad=True):
    t = tmed.temperature.data.clone() if tmed.temperature is not None else None
    g = tinv.OptimizableGrids(log_density=tinv.param_from_density(tmed.density.data).detach().clone(), temperature=t)
    for x in tinv.grid_leaves(g):
        x.requires_grad_(requires_grad)
    return g


def test_softplus_and_inverse_match_jax():
    x = np.concatenate([np.linspace(-30.0, 40.0, 701), np.random.default_rng(0).normal(0, 3, 1000)]).astype(np.float32)
    np.testing.assert_allclose(tinv.density_from_param(torch.from_numpy(x)).numpy(),
                               np.asarray(jinv.density_from_param(jnp.asarray(x))), rtol=1e-6, atol=1e-30)
    d = np.abs(x)[:800] + np.float32(1e-5)
    np.testing.assert_allclose(tinv.param_from_density(torch.from_numpy(d)).numpy(),
                               np.asarray(jinv.param_from_density(jnp.asarray(d))), rtol=1e-5, atol=1e-6)
    # Above torch's F.softplus threshold the gradient is sigmoid's, as JAX's.
    p = torch.tensor([25.0, -25.0], requires_grad=True)
    tinv.density_from_param(p).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jax.grad(lambda v: jinv.density_from_param(v).sum())(
        jnp.asarray([25.0, -25.0]))), rtol=1e-6)


@pytest.mark.parametrize("pack", [False, True])
def test_medium_with_params_matches_jax(pack):
    (jmed, *_), (tmed, *_) = _scene("fire")
    jm = jinv.medium_with_params(jmed, _jgrids(jmed), pack=pack)
    tm = tinv.medium_with_params(tmed, _tgrids(tmed), pack=pack)
    np.testing.assert_allclose(tm.density.data.detach().numpy(), np.asarray(jm.density.data), rtol=1e-6)
    np.testing.assert_allclose(tm.majorants.rows.numpy(), np.asarray(jm.majorants.rows), rtol=1e-6)
    assert not tm.majorants.rows.requires_grad and tm.density.data.requires_grad
    if pack:
        assert tm.density_rows.shape[1] == 8 and not tm.density_rows.requires_grad
        np.testing.assert_allclose(tm.density_rows.numpy(), np.asarray(jm.density_rows), rtol=1e-6)
        np.testing.assert_array_equal(tm.temperature_rows.numpy(), np.asarray(jm.temperature_rows))
    else:
        assert tm.density_rows is None and tm.temperature_rows is None


# (k, wave0) of the ray batch's cases: waves wave0 * k + i that wrap past
# 2^32 for every i (k = 4), for some (k = 3), and the largest wave (k = 1).
LOSS_RAY_CASES = [(1, 2**32 - 1), (3, 1431655765), (4, 2**30 + 3)]
LOSS_RAY_SEED = 0xDEADBEEF


def _jloss_rays(jcam, raster, pids, seed_wave, k, use_jitter):
    """The JAX package's ray batch of one loss evaluation, as its
    make_render_loss's loss_fn writes it inline."""
    from volume_path_tracer_tpu.utils import rng as jrng

    n = pids.shape[0]
    raster_k = jnp.tile(raster, (k, 1))
    pids_k = jnp.tile(pids, (k,))
    waves = seed_wave[1] * jnp.uint32(k) + jnp.arange(k, dtype=jnp.uint32)
    stream_k = jnp.repeat(jrng.mix_stream(seed_wave[0], waves), n)
    u_jit = jrng.counter_uniforms(pids_k, stream_k, jnp.int32(2**31 - 1), 2)
    o_w, d_w = jcam.generate_rays(raster_k, u_jit * (0.5 if use_jitter else 0.0))
    return o_w, d_w, pids_k, stream_k


@pytest.mark.parametrize("pid_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("use_jitter", [True, False], ids=["jitter", "no_jitter"])
@pytest.mark.parametrize("k,wave0", LOSS_RAY_CASES, ids=["k1", "k3_wraps_partly", "k4_wraps"])
def test_loss_rays_plain_matches_jax(k, wave0, use_jitter, pid_dtype):
    """loss_rays on CPU tensors runs its plain version (the plain counter
    moves, the kernel's does not) and gives the JAX package's ray batch:
    pixel ids (in the input's type) and stream words bitwise, the origins
    bitwise, the directions to a product's rounding."""
    (_, _, jcam, _), (_, _, tcam, _) = _scene("fog")
    raster, pids, _ = _batch()
    jo, jd, jp, js = _jloss_rays(jcam, jnp.asarray(raster), jnp.asarray(pids),
                                 jnp.asarray([LOSS_RAY_SEED, wave0], jnp.uint32), k, use_jitter)
    plain, kernel = tmk.PLAIN_LOSS_RAYS_LAUNCHES, tmk.LOSS_RAYS_LAUNCHES
    to, td, tp, ts = tinv.loss_rays(tcam, torch.from_numpy(raster), torch.from_numpy(pids).to(pid_dtype),
                                    (LOSS_RAY_SEED, wave0), k, use_jitter)
    assert (tmk.PLAIN_LOSS_RAYS_LAUNCHES, tmk.LOSS_RAYS_LAUNCHES) == (plain + 1, kernel)
    assert tp.dtype == pid_dtype and td.shape == (k * W * H, 3)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy() & 0xFFFFFFFF, np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_loss_rays_jitter_out_only_on_the_card():
    """jitter_out is filled by the kernel alone: on CPU tensors it raises
    rather than being left as it was."""
    (_, _, _, _), (_, _, tcam, _) = _scene("fog")
    raster, pids, _ = _batch()
    jit = torch.zeros((W * H, 2), dtype=torch.float32)
    with pytest.raises(ValueError, match="jitter_out"):
        tmk.loss_rays(tcam, torch.from_numpy(raster), torch.from_numpy(pids), (LOSS_RAY_SEED, 1), 1, True,
                      jitter_out=jit)


@pytest.mark.parametrize("name,dual", [("fog", False), ("fire", True)], ids=["plain", "dual_buffer"])
def test_render_loss_matches_jax(name, dual):
    (jmed, jprm, jcam, jbb), (tmed, tprm, tcam, tbb) = _scene(name)
    raster, pids, target = _batch()
    jloss = jinv.make_render_loss(jmed, jprm, jcam, jbb, N_ITERS, True, samples_per_step=K, dual_buffer=dual)
    tloss = tinv.make_render_loss(tmed, tprm, tcam, tbb, N_ITERS, True, samples_per_step=K, dual_buffer=dual)
    jsq, jn = jax.jit(jloss)(_jgrids(jmed), jnp.asarray(raster), jnp.asarray(pids), jnp.asarray(target),
                             jnp.asarray([3, 1], jnp.uint32))
    with torch.no_grad():
        tsq, tn = tloss(_tgrids(tmed, False), torch.from_numpy(raster), torch.from_numpy(pids),
                        torch.from_numpy(target), (3, 1))
    assert tn == float(jn) == W * H * 3
    assert np.isfinite(float(tsq)) and float(tsq) != 0.0
    np.testing.assert_allclose(float(tsq), float(jsq), rtol=1e-3)


def test_render_loss_gradient_replay_equals_oracle():
    """The loss's gradient through the path replay (use_prb=True) equals
    torch autograd through the bounded loop (use_prb=False) on the same
    batch, density and temperature: the loss wires both the same way."""
    _, (tmed, tprm, tcam, tbb) = _scene("fire")
    raster, pids, target = _batch()
    out = []
    for use_prb in (True, False):
        grids = _tgrids(tmed)
        loss_fn = tinv.make_render_loss(tmed, tprm, tcam, tbb, 64, True, samples_per_step=2, use_prb=use_prb,
                                        dual_buffer=True)
        sq, _ = loss_fn(grids, torch.from_numpy(raster), torch.from_numpy(pids), torch.from_numpy(target), (3, 1))
        sq.backward()
        out.append((float(sq.detach()), grids.log_density.grad.numpy(), grids.temperature.grad.numpy()))
    (sq_p, dp, tp), (sq_o, do, to) = out
    assert sq_p == pytest.approx(sq_o, rel=1e-6)
    for got, want in ((dp, do), (tp, to)):
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0)


def _fixed_grads(shapes, steps, seed=7):
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(s) * 10.0 ** rng.integers(-4, 1)).astype(np.float32) for s in shapes]
            for _ in range(steps)]


def _jax_steps(jgrids, jstate, grads, lr=1e-2):
    opt = optax.adam(lr)
    for g in grads:
        jg = jinv.OptimizableGrids(*[jnp.asarray(x) for x in g]) if len(g) == 2 else \
            jinv.OptimizableGrids(jnp.asarray(g[0]))
        upd, jstate = opt.update(jg, jstate, jgrids)
        jgrids = optax.apply_updates(jgrids, upd)
    return jgrids, jstate


def _port_steps(grids, opt, grads):
    for g in grads:
        for p, x in zip(tinv.grid_leaves(grids), g):
            p.grad = torch.from_numpy(x)
        opt.step()


def _start(seed=1):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (6, 5, 4)).astype(np.float32)
    b = rng.uniform(5, 15, (6, 5, 4)).astype(np.float32)
    jg = jinv.OptimizableGrids(jnp.asarray(a), jnp.asarray(b))
    tg = tinv.OptimizableGrids(torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True))
    return jg, tg


def test_adam_matches_optax():
    """The same gradients into both optimizers, five steps."""
    jg, tg = _start()
    grads = _fixed_grads([(6, 5, 4)] * 2, 5)
    jg, _ = _jax_steps(jg, optax.adam(1e-2).init(jg), grads)
    opt = tinv.make_optimizer(tg)
    _port_steps(tg, opt, grads)
    for a, b in zip(tinv.grid_leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_checkpoint_from_jax_gives_the_same_next_step(tmp_path):
    jg, tg = _start()
    grads = _fixed_grads([(6, 5, 4)] * 2, 3)
    jg2, js2 = _jax_steps(jg, optax.adam(1e-2).init(jg), grads[:2])
    path = os.path.join(tmp_path, "jax.npz")
    jinv.save_train_checkpoint(path, jg2, js2, 2)
    opt = tinv.make_optimizer(tg)
    got = tinv.load_train_checkpoint(path, tg, opt)
    assert got is not None and got[2] == 2
    leaves = jax.tree.leaves((jg2, js2))
    for a, b in zip(tinv.grid_leaves(tg), leaves[:2]):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    for p, mu, nu in zip(tinv.grid_leaves(tg), leaves[3:5], leaves[5:7]):
        st = opt.state[p]
        assert int(st["step"]) == int(leaves[2]) == 2
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(mu))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), np.asarray(nu))
    jg3, _ = _jax_steps(jg2, js2, grads[2:])
    _port_steps(tg, opt, grads[2:])
    for a, b in zip(tinv.grid_leaves(tg), jax.tree.leaves(jg3)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    assert tinv.load_train_checkpoint(os.path.join(tmp_path, "absent.npz"), tg, opt) is None


@pytest.mark.parametrize("steps", [0, 2], ids=["fresh", "after_two_steps"])
def test_checkpoint_from_port_loads_into_jax(tmp_path, steps):
    jg, tg = _start()
    grads = _fixed_grads([(6, 5, 4)] * 2, steps + 1)
    opt = tinv.make_optimizer(tg)
    _port_steps(tg, opt, grads[:steps])
    path = os.path.join(tmp_path, "port.npz")
    tinv.save_train_checkpoint(path, tg, opt, steps)
    template = (jg, optax.adam(1e-2).init(jg))
    got = jinv.load_train_checkpoint(path, *template)
    assert got is not None and got[2] == steps
    jl, js, _ = got
    assert int(js[0].count) == steps
    for a, b in zip(tinv.grid_leaves(tg), jax.tree.leaves(jl)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    jl3, _ = _jax_steps(jl, js, grads[steps:])
    _port_steps(tg, opt, grads[steps:])
    for a, b in zip(tinv.grid_leaves(tg), jax.tree.leaves(jl3)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
def test_train_step_on_cpu(pack):
    """One step of the port's train step through the plain record and replay:
    finite loss, the gradient divided by the count into Adam, the grids
    moved; the same loss as make_render_loss."""
    _, (tmed, tprm, tcam, tbb) = _scene("fog")
    raster, pids, target = _batch()
    grids = _tgrids(tmed)
    before = grids.log_density.detach().clone()
    opt = tinv.make_optimizer(grids)
    step = tinv.make_train_step(tmed, tprm, tcam, tbb, n_iters=N_ITERS, samples_per_step=2, pack=pack)
    rec, rep = tmk.PLAIN_RECORD_LAUNCHES, tmk.PLAIN_REPLAY_LAUNCHES
    args = (torch.from_numpy(raster), torch.from_numpy(pids), torch.from_numpy(target))
    grids, opt, loss = step(grids, opt, *args, (3, 1))
    assert (tmk.PLAIN_RECORD_LAUNCHES, tmk.PLAIN_REPLAY_LAUNCHES) == (rec + 1, rep + 1)
    assert np.isfinite(float(loss)) and float(loss) > 0
    g = grids.log_density.grad
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    moved = (grids.log_density.detach() - before).abs()
    assert float(moved.max()) > 0 and float(moved.max()) <= 1e-2 * 1.0001  # Adam's first step: at most lr
    loss_fn = tinv.make_render_loss(tmed, tprm, tcam, tbb, N_ITERS, True, samples_per_step=2, pack=pack)
    with torch.no_grad():
        sq, n = loss_fn(tinv.OptimizableGrids(before), *args, (3, 1))
    assert float(loss) == pytest.approx(float(sq) / n, rel=1e-6)
    assert callable(tinv.make_train_step(tmed, tprm, tcam, tbb, mesh=make_mesh(2, devices=["cpu"] * 2)))
