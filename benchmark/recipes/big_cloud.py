"""The wdas_cloud stand-in: a sparse cumulus, all of it from `shape_seed`."""
from __future__ import annotations

import torch

from ..reference.walk import Grid
from ..scenes import _axes, _gen, _value_noise


def big_cloud(n: int, shape_seed: int, occupancy: float, voxel: float, device) -> Grid:
    """A sparse cumulus of n^3 voxels, about `occupancy` of them non-zero:
    soft ellipsoidal lobes plus three octaves of value noise, thresholded.
    All of it comes from `shape_seed`: the cloud stands in for one asset."""
    gen = _gen(shape_seed, device)
    field = _value_noise(n, 6, gen, device)
    field += 0.5 * _value_noise(n, 12, gen, device)
    field += 0.25 * _value_noise(n, 24, gen, device)
    field *= 0.55
    ax = _axes(n, device, -1.0, 1.0, endpoint=True)
    x, y, z = ax.view(-1, 1, 1), ax.view(1, -1, 1), ax.view(1, 1, -1)
    centres = torch.rand((10, 3), generator=gen, device=device) * 0.9 - 0.45
    radii = torch.rand((10, 3), generator=gen, device=device) * 0.22 + 0.18
    body = torch.full((n, n, n), -1.0, device=device)
    for c, r in zip(centres.tolist(), radii.tolist()):
        d = ((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 + ((z - c[2]) / r[2]) ** 2
        torch.maximum(body, 1.0 - d, out=body)
    field += body
    del body
    flat = field.view(-1)
    stride = max(1, flat.numel() >> 24)
    sample = torch.sort(flat[::stride]).values
    thresh = sample[min(sample.numel() - 1, int((1.0 - occupancy) * sample.numel()))]
    dens = torch.clamp((field - thresh) * 2.5, 0.0, 1.0)
    h = n // 2
    return Grid(dens.contiguous(), (-h, -h, -h), float(voxel), (0.0, 0.0, 0.0))


def make(vol_cfg: dict, seed: int, device, n_override=None):
    n = n_override or vol_cfg["n"]
    return big_cloud(n, vol_cfg["shape_seed"], vol_cfg["occupancy"], vol_cfg["voxel_size"], device), None
