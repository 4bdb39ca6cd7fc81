"""The port's spans (volume_path_tracer_tpu_torch/utils/spans.py) on the CPU.

With no profiler running, span() is one shared no-op context. Under
torch.profiler the wave, the sharded wave and the train step record their
spans nested by time on the profiler's clock: render.wave holds
render.film; shard.wave one shard.cell a cell and shard.gather; train.step
the optimizer's zero_grad, train.rebuild, train.rays, prb.record,
train.backward (holding the replay, prb.replay, which holds its fold,
prb.fold) and the optimizer's step. On the card a step that runs as a CUDA
graph records train.capture where it captures and train.replay where it
replays (tests/test_torch_cuda_train_graph.py).
Every span("...") in the package is named in SPANS, and every name in SPANS
is used.
"""
import functools
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from volume_path_tracer_tpu_torch.diff import inverse as inv
from volume_path_tracer_tpu_torch.grids.procedural import fog_sphere
from volume_path_tracer_tpu_torch.models.camera import Camera
from volume_path_tracer_tpu_torch.models.medium import Medium
from volume_path_tracer_tpu_torch.parallel import shard
from volume_path_tracer_tpu_torch.render import renderer
from volume_path_tracer_tpu_torch.render.integrator import IntegratorParams
from volume_path_tracer_tpu_torch.utils import spans
from volume_path_tracer_tpu_torch.utils.config import CameraParameters

W, H = 12, 8
PARAMS = IntegratorParams(
    sigma_a=0.05, sigma_s=0.3, hg_g=0.4, le_scale=0.0, temperature_offset=300.0, temperature_scale=40.0,
    infinite_xyz=(0.25, 0.25, 0.5), infinite_multiplier=1.0, distant_xyz=(0.95, 1.0, 1.09),
    distant_multiplier=5.0, distant_inv_direction=(0.5, 1.0, 0.0), max_depth=40, max_iters=96,
)
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "volume_path_tracer_tpu_torch")


@functools.lru_cache(maxsize=None)
def _scene(pack=True):
    medium = Medium.from_grids(fog_sphere(radius=6.0, falloff=2.0), pack=pack, device="cpu")
    camera = Camera.from_parameters(CameraParameters((24.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 38.0, 0.5),
                                    (W, H), device="cpu")
    return renderer.Scene(medium, camera, PARAMS, W, H, 7, 4, True)


def _recorded(fn):
    """fn() under a CPU profile: the port's spans [(name, start, end)] by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name in spans.SPANS),
                  key=lambda s: (s[1], -s[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_no_profiler_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    off = spans.span("render.wave")
    assert all(spans.span(n) is off for n in (*spans.SPANS, "anything else"))
    with off:
        pass


def test_render_wave_holds_its_film():
    scene = _scene()
    film = renderer.render_wave_image(scene, 1)
    got = _recorded(lambda: renderer.render_wave_image(scene, 2, film, return_ncap=True))
    assert [s[0] for s in got] == ["render.wave", "render.film"]
    assert _inside(got[1], got[0])


def test_sharded_wave_holds_its_cells_and_gather():
    scene = _scene()
    mesh = shard.make_mesh(2, 1, devices=["cpu"] * 2)
    raster, pids, _ = shard.pad_ray_batch(W, H, 2)
    got = _recorded(lambda: shard.render_wave_sharded(mesh, scene.medium, scene.params, scene.camera, None,
                                                      raster, pids, scene.seed, 1, True))
    assert [s[0] for s in got] == ["shard.wave", "shard.cell", "shard.cell", "shard.gather"]
    assert all(_inside(s, got[0]) for s in got[1:])
    assert got[1][2] <= got[2][1] and got[2][2] <= got[3][1]


def test_train_step_phases_in_order():
    scene = _scene(pack=False)
    base = scene.medium
    ys, xs = np.mgrid[0:H, 0:W]
    raster = torch.from_numpy(np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32))
    pids = torch.arange(W * H, dtype=torch.int32)
    grids = inv.OptimizableGrids(inv.param_from_density(base.density.data).requires_grad_(True))
    opt = inv.make_optimizer(grids)
    step = inv.make_train_step(base, PARAMS, scene.camera, None, n_iters=64, samples_per_step=2)
    target = torch.zeros((W * H, 3))
    got = _recorded(lambda: step(grids, opt, raster, pids, target, (3, 1)))
    names = [s[0] for s in got]
    assert names == ["train.step", "train.optimizer", "train.rebuild", "train.rays", "prb.record",
                     "train.backward", "prb.replay", "prb.fold", "train.optimizer"]
    top, phases = got[0], [s for s in got[1:] if s[0] not in ("prb.replay", "prb.fold")]
    assert all(_inside(s, top) for s in got[1:])
    # the phases are disjoint and in order on the calling thread; the replay runs inside the backward
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    assert _inside(got[names.index("prb.replay")], got[names.index("train.backward")])
    assert _inside(got[names.index("prb.fold")], got[names.index("prb.replay")])


def _used_names():
    used = set()
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py") and f != "spans.py":
                with open(os.path.join(d, f)) as fh:
                    used |= set(re.findall(r"""\bspan\(\s*["']([^"']+)["']""", fh.read()))
    return used


def test_every_span_named_in_spans_and_used():
    used = _used_names()
    assert used == set(spans.SPANS)
    assert len(spans.SPANS) == len(set(spans.SPANS))


def test_spans_name_the_graph_step():
    """The train step's CUDA graph records its capture and its replay."""
    assert {"train.capture", "train.replay"} <= set(spans.SPANS)


@pytest.mark.parametrize("name", ["render.wave", "train.step", "train.capture", "train.replay"])
def test_span_under_a_profiler_records_its_name(name):
    def body():
        with spans.span(name):
            torch.zeros(4).sum()

    got = _recorded(body)
    assert [s[0] for s in got] == [name]
