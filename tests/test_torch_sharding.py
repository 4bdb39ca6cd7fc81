"""The port's sharded rendering (parallel/) on a mesh of CPU cells.

The counterparts of tests/test_sharding.py's rendering tests, on the same
_scene() inputs (tests/torch_sharding_fixtures.py): a mesh of 8 cells on
the CPU, the port's counterpart of the JAX tests' virtual devices. A film
sharded over 'rays' is bitwise the one-device wave on any mesh shape;
'spp' equals sequential global waves at rtol/atol 2e-5 (the sum's
rounding); lane-iterations are one count on 1 cell, 8x1 and 4x2, and
trace_rays, trace_lanes and render_wave count them alike; the padded
batches are JAX's arrays, with the sentinel npix. Against JAX's sharded
film: tests/test_torch_sharding_jax.py; training:
tests/test_torch_sharding_train.py.
"""
import numpy as np
import pytest
import torch

from volume_path_tracer_tpu.parallel import multihost as jmultihost
from volume_path_tracer_tpu.parallel import shard as jshard
from volume_path_tracer_tpu_torch.parallel import multihost, shard
from volume_path_tracer_tpu_torch.render import integrator as tint
from volume_path_tracer_tpu_torch.render import megakernel as tmk
from volume_path_tracer_tpu_torch.utils import rng as trng

from tests.torch_sharding_fixtures import batch, cpu_mesh, one_device_wave, scene

torch.set_num_threads(2)


def test_rays_sharding_matches_single_device():
    _, (med, cam, prm), W, H = scene()
    raster, pids = batch(W, H)
    sharded, n_capped, _ = shard.render_wave_sharded(cpu_mesh(8), med, prm, cam, None, raster, pids, 7, 3, True)
    assert int(n_capped) == 0
    assert torch.equal(sharded, one_device_wave(med, cam, prm, W, H, 7, 3))


def test_spp_axis_matches_sequential_waves():
    _, (med, cam, prm), W, H = scene()
    raster, pids = batch(W, H)
    # rays=2, spp=4: wave 1 covers global waves 4..7
    sharded, _, _ = shard.render_wave_sharded(cpu_mesh(8, spp=4), med, prm, cam, None, raster, pids, 7, 1, True)
    seq = sum(one_device_wave(med, cam, prm, W, H, 7, gw) for gw in (4, 5, 6, 7))
    np.testing.assert_allclose(sharded.numpy(), seq.numpy(), rtol=2e-5, atol=2e-5)
    assert (sharded[:, 3] == 4).all()


def test_mesh_shape_invariance():
    _, (med, cam, prm), W, H = scene()
    raster, pids = batch(W, H)
    a, _, _ = shard.render_wave_sharded(cpu_mesh(8), med, prm, cam, None, raster, pids, 7, 5, True)
    b, _, _ = shard.render_wave_sharded(cpu_mesh(4), med, prm, cam, None, raster, pids, 7, 5, True)
    assert torch.equal(a, b)


def test_film_sharded_equals_render_passes():
    """render_film_sharded's film over 4x1 and 2x2 meshes: 'rays' bitwise the
    one-device waves added in order, 'spp' within the sum's rounding."""
    _, (med, cam, prm), W, H = scene()
    seq = torch.zeros((H, W, 4))
    for w in (1, 2):
        tmk.render_wave(med, prm, cam, None, seq, range(0, W * H), trng.mix_stream(7, w), True, cam.imaging_ratio)
    film = shard.render_film_sharded(cpu_mesh(4), med, prm, cam, None, W, H, 7, 2)
    assert torch.equal(film, seq)
    # 2x2: the call at wave 1 renders global waves 2 and 3
    seq2 = sum(one_device_wave(med, cam, prm, W, H, 7, gw) for gw in (2, 3)).view(H, W, 4)
    seen = []
    film2 = shard.render_film_sharded(cpu_mesh(4, spp=2), med, prm, cam, None, W, H, 7, 2,
                                      wave_callback=lambda n, f: seen.append(n))
    assert seen == [2]
    np.testing.assert_allclose(film2.numpy(), seq2.numpy(), rtol=2e-5, atol=2e-5)


def test_padding_sentinel_is_npix_in_both_batch_builders():
    """pad_ray_batch and make_global_ray_batch give JAX's arrays, padded with
    the out-of-image id npix; the padding rows of a sharded wave stay zero
    and the in-image rows equal the one-device wave's."""
    W, H = 5, 3  # 15 pixels: pads on the 8-way axis
    raster, pids, npix = shard.pad_ray_batch(W, H, n_align=8)
    j_raster, j_pids, j_npix = jshard.pad_ray_batch(W, H, n_align=8)
    np.testing.assert_array_equal(raster, j_raster)
    np.testing.assert_array_equal(pids, j_pids)
    assert npix == j_npix == 15 and list(pids[npix:]) == [npix]
    g_raster, g_pids, g_npix = multihost.make_global_ray_batch(cpu_mesh(8, spp=2), W, H)
    jg_raster, jg_pids, jg_npix = jmultihost.make_global_ray_batch(jshard.make_mesh(8, spp=2), W, H)
    np.testing.assert_array_equal(g_raster, np.asarray(jg_raster))
    np.testing.assert_array_equal(g_pids, np.asarray(jg_pids))
    assert g_npix == jg_npix == npix

    _, (med, cam, prm), _, _ = scene()
    contrib, _, _ = shard.render_wave_sharded(cpu_mesh(8), med, prm, cam, None, raster, pids, 7, 3, True)
    assert not contrib[npix:].any()
    film = torch.zeros((H, W, 4))
    tmk.render_wave(med, prm, cam, None, film, range(0, npix), trng.mix_stream(7, 3), True, cam.imaging_ratio)
    assert torch.equal(contrib[:npix], film.view(-1, 4))


def test_lane_iterations_topology_invariant():
    """Lane-iterations (the lanes alive after each step, summed) on 1 cell,
    8x1 and 4x2 are one count, the sum of the one-device counts of the
    global waves a layout renders; trace_rays, trace_rays_fused (through
    trace_lanes) and render_wave count them alike."""
    _, (med, cam, prm), W, H = scene()
    raster, pids = batch(W, H)
    counts = {}
    for name, mesh in (("1", cpu_mesh(1)), ("8x1", cpu_mesh(8)), ("4x2", cpu_mesh(8, spp=2))):
        _, _, _, lane_it = shard.render_wave_sharded(mesh, med, prm, cam, None, raster, pids, 7, 2, True,
                                                     return_lane_iters=True)
        counts[name] = int(lane_it)

    def single(global_wave, every_path=False):
        stream = trng.mix_stream(7, global_wave)
        u = trng.counter_uniforms(torch.from_numpy(pids), stream, tmk.JITTER_COUNTER, 2)
        o_w, d_w = cam.generate_rays(torch.from_numpy(raster), u * 0.5)
        out = tint.trace_rays(med, prm, None, o_w, d_w, torch.from_numpy(pids), stream, return_lane_iters=True)
        if every_path:
            fused = tmk.trace_rays_fused(med, prm, None, o_w, d_w, torch.from_numpy(pids), stream,
                                         return_lane_iters=True)
            film = torch.zeros((H, W, 4))
            wave = tmk.render_wave(med, prm, cam, None, film, range(0, W * H), stream, True, cam.imaging_ratio,
                                   return_lane_iters=True)
            assert int(out[3]) == int(fused[3]) == int(wave[2]) > 0
        return int(out[3])

    assert counts["1"] == counts["8x1"] == single(2, every_path=True), counts
    assert counts["4x2"] == single(4) + single(5), counts


def test_lane_iterations_of_a_split_loop_add_up():
    """trace_lanes' count of a loop split at max_steps = 5: the two calls'
    counts add up to the whole loop's, which is integrator.lane_iterations
    of its final state."""
    _, (med, cam, prm), W, H = scene()
    raster, pids = batch(W, H)
    stream = trng.mix_stream(7, 1)
    u = trng.counter_uniforms(torch.from_numpy(pids), stream, tmk.JITTER_COUNTER, 2)
    o_w, d_w = cam.generate_rays(torch.from_numpy(raster), u * 0.5)
    sf, si = tmk.pack_state(tint.init_state(med, o_w, d_w, prm))
    streams = tint.lane_streams(stream, W * H, sf.device)
    ids = torch.from_numpy(pids)
    *whole, n_whole = tmk.trace_lanes(med, prm, None, sf, si, ids, streams, prm.max_iters, return_lane_iters=True)
    *part, n1 = tmk.trace_lanes(med, prm, None, sf, si, ids, streams, 5, return_lane_iters=True)
    *rest, n2 = tmk.trace_lanes(med, prm, None, *part, ids, streams, prm.max_iters, return_lane_iters=True)
    assert torch.equal(rest[1], whole[1])
    assert int(n1) + int(n2) == int(n_whole) == int(tint.lane_iterations(tmk.unpack_state(*whole)))


def test_mesh_construction():
    """make_mesh lays cells row-major, repeats a device on request, and
    raises for devices left unset without CUDA; ray_plan refuses a batch
    whose ids are not its pixels', and one whose shard is not a run of
    consecutive pixels."""
    mesh = cpu_mesh(8, spp=2)
    assert mesh.shape == {"rays": 4, "spp": 2} and mesh.size == 8 and not mesh.spans_processes
    assert [(r, s) for r, s, _ in mesh.local_cells()] == [(r, s) for r in range(4) for s in range(2)]
    assert mesh.home == torch.device("cpu")
    with pytest.raises(ValueError):
        cpu_mesh(6, spp=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard.make_mesh()
    raster, pids, _ = shard.pad_ray_batch(4, 2, 1)
    with pytest.raises(ValueError, match="not the row-major ids"):
        shard.ray_plan(raster, pids[::-1].copy(), 1)
    with pytest.raises(ValueError, match="occurs twice"):
        shard.ray_plan(np.concatenate([raster, raster[:1]]), np.concatenate([pids, pids[:1]]), 1)
    with pytest.raises(ValueError, match="not one run of consecutive pixels"):
        shard.ray_plan(raster[::-1].copy(), pids[::-1].copy(), 2)
    assert shard.ray_plan(raster, pids, 2).shards[1] == (slice(4, 8), range(4, 8))
    assert shard.tree_sum([1, 2, 3, 4, 5]) == ((1 + 2) + (3 + 4)) + 5


@pytest.mark.parametrize("form", ["packed", "unpacked"])
def test_to_device_copies_once_and_keeps_the_form(form):
    """to_device hands back the object on its own device, and elsewhere one
    copy while the object lives (so kernel constants are found again): a
    packed medium keeps its tables, an unpacked one stays without them, its
    grids copied as they are and handed to the kernels as they are, the
    camera its tensors."""
    _, (med, cam, _), _, _ = scene()
    m = med if form == "packed" else tint_unpacked(med)
    assert shard.to_device(m, "cpu") is m and shard.to_device(None, "meta") is None
    on = shard.to_device(m, "meta")
    assert on is shard.to_device(m, "meta") and on.device.type == "meta"
    assert (on.density_rows is None) == (form == "unpacked")
    assert on.majorants.rows.device.type == "meta"
    assert on.density.shape == m.density.shape and on.density.origin_ijk == m.density.origin_ijk
    if form == "unpacked":
        # a CPU device of another index: a copy that holds the values
        moved = shard.to_device(m, "cpu:1")
        assert moved is not m and moved.density.data.data_ptr() != m.density.data.data_ptr()
        assert torch.equal(moved.density.data, m.density.data)
        assert torch.equal(moved.majorants.rows, m.majorants.rows) and moved.density_rows is None
        dd, td = tmk.dense_arrays(moved, False)
        assert dd is moved.density.data and td is None
    c = shard.to_device(cam, "meta")
    assert c.device.type == "meta" and c.imaging_ratio == cam.imaging_ratio
    with pytest.raises(TypeError):
        shard.to_device(object(), "meta")


def tint_unpacked(med):
    from volume_path_tracer_tpu_torch.models.medium import Medium

    return Medium.from_grids(med.density, pack=False, device="cpu")
