"""The port's sharded train step (diff/inverse.py make_train_step(mesh=...)).

tests/test_sharding.py's training inputs on meshes of CPU cells: on 8x1 the
loss and gradients match one device's at rtol 1e-5 and rtol 1e-4, atol 1e-6
(the sum over cells rounds otherwise); the update is Adam's on the summed
gradient; a batch that does not split over 'rays' raises. Against JAX's
sharded step on make_mesh(8): the loss at rtol 1e-3 and the gradient at
1e-3 of its largest magnitude (tests/test_torch_inverse.py's tolerance for
one device: the packages' paths differ in last bits, which can flip a
knife-edge event on a rare lane). JAX's gradient is read exactly: its step
runs optax.sgd(-1.0) from log density 0, so its new grids are 0 + g.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from volume_path_tracer_tpu.diff import inverse as jinv
from volume_path_tracer_tpu.parallel import shard as jshard
from volume_path_tracer_tpu_torch.diff import inverse as tinv

from tests.torch_sharding_fixtures import cpu_mesh, port_step, train_inputs

torch.set_num_threads(2)


def test_sharded_grads_match_single_device_and_jax():
    (jbase, jcam, jprm), (base, cam, prm), raster, pids, target = train_inputs()
    loss1, g1 = port_step(None, base, cam, prm, raster, pids, target)
    lossN, gN = port_step(cpu_mesh(8), base, cam, prm, raster, pids, target)
    np.testing.assert_allclose(lossN, loss1, rtol=1e-5)
    np.testing.assert_allclose(gN, g1, rtol=1e-4, atol=1e-6)
    # 4x2: other waves, another estimate of the same loss
    loss2, g2 = port_step(cpu_mesh(8, spp=2), base, cam, prm, raster, pids, target)
    assert np.isfinite(loss2) and np.isfinite(g2).all() and np.abs(g2).max() > 0 and loss2 != lossN

    opt = optax.sgd(-1.0)
    jgrids = jinv.OptimizableGrids(log_density=jnp.zeros(jbase.density.shape))
    jstep = jinv.make_train_step(jbase, jprm, jcam, None, opt, n_iters=64, mesh=jshard.make_mesh(8, spp=1),
                                 samples_per_step=1)
    jg, _, jloss = jstep(jgrids, opt.init(jgrids), jnp.asarray(raster), jnp.asarray(pids), jnp.asarray(target),
                         jnp.asarray([3, 1], jnp.uint32))
    jg = np.asarray(jg.log_density)
    np.testing.assert_allclose(lossN, float(jloss), rtol=1e-3)
    np.testing.assert_allclose(gN, jg, atol=1e-3 * np.abs(jg).max(), rtol=0)


def test_sharded_step_updates_like_one_device_and_rejects_ragged_batches():
    _, (base, cam, prm), raster, pids, target = train_inputs()
    args = (torch.from_numpy(raster), torch.from_numpy(pids), torch.from_numpy(target), (3, 1))
    out = []
    for mesh in (None, cpu_mesh(4)):
        grids = tinv.OptimizableGrids(torch.zeros(base.density.shape, requires_grad=True))
        opt = tinv.make_optimizer(grids)
        step = tinv.make_train_step(base, prm, cam, None, n_iters=64, mesh=mesh, samples_per_step=1)
        step(grids, opt, *args)
        out.append(grids.log_density.detach().numpy())
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=1e-6)
    step = tinv.make_train_step(base, prm, cam, None, n_iters=64, mesh=cpu_mesh(3), samples_per_step=1)
    grids = tinv.OptimizableGrids(torch.zeros(base.density.shape, requires_grad=True))
    with pytest.raises(ValueError, match="do not split into 3"):
        step(grids, tinv.make_optimizer(grids), *args)
