"""The benchmark's inputs, made on the device from the run's seed.

Grids come from torch rewrites of the procedural stand-ins the repository
uses for its absent assets (big_cloud, a wdas_cloud-scale cumulus, and
fire_plume, a plume with its own temperature transform). They run on the
card in a few large calls. A cloud stands in for one asset, the same in
every run: a configuration's `volume.shape_seed` makes all of it (a run
seed that remade it would change each wave's work by several per cent).
The run seed draws a plume's noise, the targets of a fit, every render's
stream words and the check's sample. Each recipe is a module of its own in
benchmark/recipes/, found by the configuration's `volume.recipe`.
"""
from __future__ import annotations

import importlib
import math

import torch

from .reference.walk import Transport


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return g


def _axes(n: int, device, lo: float, hi: float, endpoint: bool):
    a = torch.linspace(lo, hi, n + (0 if endpoint else 1), device=device, dtype=torch.float32)
    return a if endpoint else a[:-1]


def _value_noise(n: int, cells: int, gen: torch.Generator, device) -> torch.Tensor:
    """[n, n, n] smooth value noise: a (cells + 1)^3 lattice of normals, read
    trilinearly with smoothstepped fractions."""
    lattice = torch.randn((cells + 1,) * 3, generator=gen, device=device)
    t = _axes(n, device, 0.0, float(cells), endpoint=False)
    i0 = torch.floor(t).long()
    f = t - i0
    f = f * f * (3.0 - 2.0 * f)
    ix, iy, iz = i0.view(-1, 1, 1), i0.view(1, -1, 1), i0.view(1, 1, -1)
    fx, fy, fz = f.view(-1, 1, 1), f.view(1, -1, 1), f.view(1, 1, -1)
    out = torch.zeros((n, n, n), device=device)
    for dx in (0, 1):
        wx = fx if dx else 1.0 - fx
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            for dz in (0, 1):
                wz = fz if dz else 1.0 - fz
                out += lattice[ix + dx, iy + dy, iz + dz] * (wx * wy * wz)
    return out


def make_volume(vol_cfg: dict, seed: int, device, n_override=None):
    """(density Grid, temperature Grid or None) of a configuration's
    `volume`, made by its recipe: benchmark/recipes/<recipe>.py, found by
    name (n_override: another size of the same recipe, where it has one)."""
    recipe = importlib.import_module("benchmark.recipes." + vol_cfg["recipe"])
    return recipe.make(vol_cfg, seed, device, n_override)


def transport(cfg: dict) -> Transport:
    vp, wp = cfg["volume_parameters"], cfg["worker_parameters"]
    inf, dist = wp["infinite_light"], wp["distant_light"]
    return Transport(
        sigma_a=vp["sigma_a"], sigma_s=vp["sigma_s"], g=vp["henyey_greenstein_g"], le_scale=vp["le_scale"],
        temperature_offset=vp["temperature_offset"], temperature_scale=vp["temperature_scale"],
        infinite_xyz=tuple(inf["xyz"]), infinite_multiplier=inf["multiplier"],
        distant_xyz=tuple(dist["xyz"]), distant_multiplier=dist["multiplier"],
        distant_inv_direction=tuple(dist["inv_direction"]), max_depth=wp["max_depth"],
        super_tau=cfg.get("super_tau", 8.0),
    )


def ring_cameras(views: int, radius: float, height: float = 0.0):
    """`views` camera positions on a horizontal ring around the origin."""
    return [(radius * math.cos(2.0 * math.pi * k / views), height, radius * math.sin(2.0 * math.pi * k / views))
            for k in range(views)]


def smooth_targets(views: int, width: int, height: int, seed: int, device, background, peak: float):
    """[views, width * height, 3] smooth target images: a background plus a
    few soft blobs each, made from the seed (never rendered)."""
    gen = _gen(seed ^ 0x5EED, device)
    ys = torch.arange(height, device=device, dtype=torch.float32).view(-1, 1) / height
    xs = torch.arange(width, device=device, dtype=torch.float32).view(1, -1) / width
    bg = torch.tensor(background, device=device, dtype=torch.float32)
    out = []
    for _ in range(views):
        img = bg.expand(height, width, 3).clone()
        p = torch.rand((4, 6), generator=gen, device=device)
        for cx, cy, s, r, gr, b in p.tolist():
            blob = torch.exp(-((xs - (0.2 + 0.6 * cx)) ** 2 + (ys - (0.2 + 0.6 * cy)) ** 2) / (0.02 + 0.05 * s))
            img += peak * blob[..., None] * torch.tensor([0.6 + 0.4 * r, 0.6 + 0.4 * gr, 0.6 + 0.4 * b],
                                                         device=device)
        out.append(img.reshape(-1, 3))
    return torch.stack(out)
