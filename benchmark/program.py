"""The system under test, driven through the port's public entry points,
and the window loops the drivers in benchmark/drivers/ run.

render: render.renderer.render_wave_image(scene, w, film, None,
return_ncap=True) wave after wave, each followed by a synchronize, as
cli.main's wave loop does, a new film after the scene's num_waves; with
several devices parallel.shard.render_wave_sharded over make_mesh(n, 1),
the films summed onto the first device as cli._render_wave_sharded does.
train: diff.inverse.make_train_step (its defaults: pack=False, use_prb=True),
one camera of a ring a step, torch.optim.Adam from make_optimizer.
A configuration's or a mix's `medium` (keyword arguments of
Medium.from_grids, such as "pack") reaches the port as it stands, so a
variant of the medium's path is a data file.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import torch

from volume_path_tracer_tpu_torch.diff import inverse
from volume_path_tracer_tpu_torch.grids.grid import dense_grid_from_array
from volume_path_tracer_tpu_torch.models.camera import Camera
from volume_path_tracer_tpu_torch.models.medium import Medium
from volume_path_tracer_tpu_torch.parallel import shard
from volume_path_tracer_tpu_torch.render import renderer
from volume_path_tracer_tpu_torch.render.integrator import IntegratorParams
from volume_path_tracer_tpu_torch.utils.config import CameraParameters

from . import scenes


def sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _grid(g):
    return dense_grid_from_array(g.data, g.origin, g.voxel, g.offset)


def _params(cfg: dict, max_iters: int) -> IntegratorParams:
    t = scenes.transport(cfg)
    return IntegratorParams(
        sigma_a=t.sigma_a, sigma_s=t.sigma_s, hg_g=t.g, le_scale=t.le_scale,
        temperature_offset=t.temperature_offset, temperature_scale=t.temperature_scale,
        infinite_xyz=t.infinite_xyz, infinite_multiplier=t.infinite_multiplier,
        distant_xyz=t.distant_xyz, distant_multiplier=t.distant_multiplier,
        distant_inv_direction=t.distant_inv_direction, max_depth=t.max_depth,
        max_iters=max_iters, super_tau=t.super_tau,
    )


def _camera(position, look, up, vfov, ratio, width, height, device) -> Camera:
    return Camera.from_parameters(CameraParameters(tuple(position), tuple(look), tuple(up), float(vfov), float(ratio)),
                                  (width, height), device=device)


def build_medium(devices, density, temperature=None, **kw):
    """Medium.from_grids on the first device, and its seconds (synced)."""
    sync(devices)
    t0 = time.perf_counter()
    medium = Medium.from_grids(_grid(density), _grid(temperature) if temperature is not None else None,
                               device=devices[0], **kw)
    sync(devices)
    return medium, time.perf_counter() - t0


def medium_options(cfg: dict, mix: dict, **default) -> dict:
    """Medium.from_grids' keyword arguments: the defaults, then the
    configuration's `medium`, then the mix's."""
    return {**default, **cfg.get("medium", {}), **mix.get("medium", {})}


class RenderProgram:
    """One scene rendered wave by wave, on one device or over a mesh."""

    def __init__(self, cfg: dict, density, temperature, seed: int, devices: List[torch.device],
                 medium: Optional[dict] = None):
        self.devices = devices
        W, H = cfg["output_size"]
        self.width, self.height = W, H
        self.medium, self.medium_build_s = build_medium(devices, density, temperature, **(medium or {}))
        cam = cfg["camera"]
        camera = _camera(cam["position"], cam["look"], cam["up"], cam["vfov_deg"], cam["imaging_ratio"], W, H,
                         devices[0])
        self.scene = renderer.Scene(self.medium, camera, _params(cfg, cfg["max_iters"]), W, H, seed,
                                    cfg["num_waves"], cfg["use_jitter"])
        self.num_waves = cfg["num_waves"]
        self.mesh = shard.make_mesh(len(devices), 1, devices=devices) if len(devices) > 1 else None
        self.batch = shard.pad_ray_batch(W, H, len(devices)) if self.mesh is not None else None

    def wave(self, w: int, film: Optional[torch.Tensor]):
        """Wave w added to the film (None: a new one): (new film, n_capped)."""
        s = self.scene
        if self.mesh is None:
            return renderer.render_wave_image(s, w, film, None, return_ncap=True)
        coords, pids, npix = self.batch
        contrib, n_capped, _ = shard.render_wave_sharded(self.mesh, s.medium, s.params, s.camera, s.bb_table,
                                                         coords, pids, s.seed, w, s.use_jitter)
        base = torch.zeros((self.height, self.width, 4), dtype=torch.float32, device=self.devices[0]) \
            if film is None else film
        return base + contrib[:npix].reshape(self.height, self.width, 4), n_capped


class TrainProgram:
    """Inverse rendering of one density grid from a ring of views."""

    def __init__(self, cfg: dict, mix: dict, density, p0: torch.Tensor, targets: torch.Tensor, seed: int,
                 devices: List[torch.device]):
        dev = devices[0]
        self.devices = devices
        self.base, self.medium_build_s = build_medium(devices, density, **medium_options(cfg, mix, pack=False))
        w, h = mix["pixels"]
        cam = cfg["camera"]
        params = _params(cfg, mix["n_iters"])
        self.steps = [
            inverse.make_train_step(self.base, params,
                                    _camera(pos, (0.0, 0.0, 0.0), cam["up"], mix["vfov_deg"], cam["imaging_ratio"],
                                            w, h, dev),
                                    None, n_iters=mix["n_iters"], samples_per_step=mix["samples_per_step"])
            for pos in scenes.ring_cameras(mix["views"], mix["ring_radius"])
        ]
        self.grids = inverse.OptimizableGrids(p0.clone().requires_grad_(True))
        self.opt = inverse.make_optimizer(self.grids, lr=mix["lr"])
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.int32), torch.arange(w, dtype=torch.int32), indexing="ij")
        self.raster = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(dev)
        self.pids = torch.arange(w * h, dtype=torch.int32, device=dev)
        self.targets = targets
        self.seed32 = int(seed) & 0xFFFFFFFF
        self.lanes = w * h * mix["samples_per_step"]
        self.saved = None

    @property
    def param(self) -> torch.Tensor:
        return self.grids.log_density

    def step(self, i: int) -> torch.Tensor:
        """Step i: view i mod views, waves of seed-wave (seed, i); its loss (not read)."""
        v = i % len(self.steps)
        _, _, loss = self.steps[v](self.grids, self.opt, self.raster, self.pids, self.targets[v], (self.seed32, i))
        return loss

    def first_gradient(self) -> torch.Tensor:
        """The gradient the optimizer took at its first step, from its state (m1 / (1 - beta1))."""
        st = self.opt.state[self.param]
        return st["exp_avg"] / (1.0 - self.opt.param_groups[0]["betas"][0])

    def save(self):
        st = self.opt.state[self.param]
        self.saved = (self.param.detach().clone(), {k: v.clone() for k, v in st.items()})

    def restore(self):
        p, st = self.saved
        with torch.no_grad():
            self.param.copy_(p)
        for k, v in self.opt.state[self.param].items():
            v.copy_(st[k])


class Window(NamedTuple):
    seconds: float  # host clock, first issue to the last unit's completion
    units: int  # waves or steps completed in it
    unit_ms: List[float]  # each wave's time, issue to completion (device events on a card)
    call_s: List[float]  # host seconds of each call into the program (its issue)
    n_capped: int


def render_window(prog: RenderProgram, seconds: float, keep=None, on_close=None):
    """Waves back to back for `seconds`, each synced. keep: {window wave
    position: pixel ids [n] on the first device}, whose rows of the film
    before and after that wave are kept for the check (a gather, not the
    films); the loop runs on, untimed, until each has come. on_close() runs
    as the window closes. Returns (Window, {position: (wave, before, after)})."""
    keep = keep or {}
    dev0 = prog.devices[0]
    cuda = dev0.type == "cuda"
    film, w, n = None, 0, 0
    kept, unit_ms, call_s = {}, [], []
    ncap = torch.zeros((), dtype=torch.int64, device=dev0)
    events = []
    t_start = time.perf_counter()
    window = None
    last = max(keep, default=-1)
    while window is None or n <= last:
        if w == prog.num_waves:
            film, w = None, 0
        w += 1
        before = film
        if cuda and window is None:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        film, nc = prog.wave(w, film)
        t1 = time.perf_counter()
        if cuda and window is None:
            e1.record()
        sync(prog.devices)
        t2 = time.perf_counter()
        if n in keep:
            idx = keep[n]
            rows = film.reshape(-1, 4)[idx]
            kept[n] = (w, None if before is None else before.reshape(-1, 4)[idx], rows)
        if window is None:
            ncap += nc
            call_s.append(t1 - t0)
            if cuda:
                events.append((e0, e1))
            else:
                unit_ms.append((t2 - t0) * 1e3)
            if t2 - t_start >= seconds:
                window = t2 - t_start
                units = n + 1
                if on_close is not None:
                    on_close()
        n += 1
    unit_ms = unit_ms or [a.elapsed_time(b) for a, b in events]
    return Window(window, units, unit_ms, call_s, int(ncap)), kept


def train_window(prog: TrainProgram, seconds: float, first: int, restore_every: int):
    """Steps first, first + 1, ... for `seconds`, no loss read, the grids and
    Adam state restored every `restore_every` steps. Returns the Window."""
    call_s = []
    t_start = time.perf_counter()
    i = first
    while True:
        if i > first and (i - first) % restore_every == 0:
            prog.restore()
        t0 = time.perf_counter()
        prog.step(i)
        call_s.append(time.perf_counter() - t0)
        i += 1
        if time.perf_counter() - t_start >= seconds:
            break
    sync(prog.devices)
    return Window(time.perf_counter() - t_start, i - first, [], call_s, 0)
