"""The fire stand-in: a plume whose noise comes from the run seed, with a temperature grid."""
from __future__ import annotations

import math

import torch

from ..reference.walk import Grid
from ..scenes import _gen


def fire_plume(height: int, radius: float, voxel: float, seed: int, device):
    """(density, temperature) of a tapering plume; the temperature grid keeps
    a transform of its own, shifted by half a voxel in x and z."""
    rad = int(math.ceil(radius)) + 2
    nx = 2 * rad + 1
    ix = (torch.arange(nx, device=device, dtype=torch.float32) - rad).view(-1, 1, 1)
    iy = torch.arange(height, device=device, dtype=torch.float32).view(1, -1, 1)
    iz = (torch.arange(nx, device=device, dtype=torch.float32) - rad).view(1, 1, -1)
    taper = 1.0 - 0.6 * (iy / height)
    rr = torch.sqrt(ix * ix + iz * iz) / (radius * torch.clamp(taper, min=0.2))
    base = torch.clamp(1.0 - rr, 0.0, 1.0)

    def smooth(e0, e1, v):
        t = torch.clamp((v - e0) / (e1 - e0), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    vertical = smooth(0.0, 5.0, iy) * (1.0 - smooth(0.7 * height, float(height), iy))
    noise = torch.rand((nx, height, nx), generator=_gen(seed, device), device=device) * 0.4 + 0.6
    dens = (base * vertical * noise).contiguous()
    temp = ((base ** 2) * (1.0 - 0.8 * (iy / height)) * 30.0).expand(nx, height, nx).contiguous()
    origin = (-rad, 0, -rad)
    return (Grid(dens, origin, float(voxel), (0.0, 0.0, 0.0)),
            Grid(temp, origin, float(voxel), (0.5 * voxel, 0.0, 0.5 * voxel)))


def make(vol_cfg: dict, seed: int, device, n_override=None):
    return fire_plume(vol_cfg["height"], vol_cfg["radius"], vol_cfg["voxel_size"], seed, device)
