"""The port's sharded film and lane-iterations against the JAX package's.

render_wave_sharded on a 4x2 mesh of CPU cells against JAX's
render_wave_sharded on make_mesh(8, spp=2) (tests/conftest.py's virtual
devices), on tests/test_sharding.py's _scene(): the film passes the
statistic the port is held to against JAX elsewhere
(tests/test_torch_integrator.py: lane-close > 0.95 at rtol 1e-4, atol 1e-5,
channel means within 5%, equal weights and n_capped), and the
lane-iteration counts agree within 5% (the packages' paths differ in last
bits, which can flip a knife-edge event on a rare lane).
"""
import jax.numpy as jnp
import numpy as np
import torch

from volume_path_tracer_tpu.parallel import shard as jshard
from volume_path_tracer_tpu_torch.parallel import shard

from tests.torch_sharding_fixtures import batch, cpu_mesh, scene

torch.set_num_threads(2)


def test_sharded_film_and_lane_iterations_match_jax():
    (jmed, jcam, jprm), (med, cam, prm), W, H = scene()
    raster, pids = batch(W, H)
    got, nc, _, lanes = shard.render_wave_sharded(cpu_mesh(8, spp=2), med, prm, cam, None, raster, pids, 7, 3,
                                                  True, return_lane_iters=True)
    want, jnc, _, jlanes = jshard.render_wave_sharded(jshard.make_mesh(8, spp=2), jmed, jprm, jcam, None,
                                                      jnp.asarray(raster), jnp.asarray(pids), 7, 3, True,
                                                      return_lane_iters=True)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    close = np.isclose(got[:, :3], want[:, :3], rtol=1e-4, atol=1e-5).all(-1).mean()
    assert close > 0.95, close
    m, jm = got[:, :3].mean(0), want[:, :3].mean(0)
    assert (np.abs(m - jm) / np.abs(jm) < 0.05).all(), (m, jm)
    assert int(nc) == int(jnc) == 0
    assert abs(int(lanes) - int(jlanes)) / int(jlanes) < 0.05, (int(lanes), int(jlanes))
