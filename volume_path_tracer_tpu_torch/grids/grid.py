"""Dense voxel grids and the corner-packed row table.

Port of volume_path_tracer_tpu/grids/grid.py. A volume is a dense [X, Y, Z]
float32 tensor over the active index bounding box, with a uniform-scale
index/world transform: world = ijk * voxel_size + world_offset, and voxel
(i, j, k) of `data` at absolute index origin_ijk + (i, j, k). Trilinear
samples outside the box read the background value 0.

The integrator's hot path samples through the corner-packed table
(pack_corner_rows): row r holds the 8 trilinear corners of base voxel r, so
one row read serves one trilinear sample.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DenseGrid:
    """A dense voxel grid over the active index bbox of a volume."""

    data: torch.Tensor  # [X, Y, Z] float32
    origin_ijk: Tuple[int, int, int]
    voxel_size: float
    world_offset: Tuple[float, float, float]

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.data.shape)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "DenseGrid":
        return dataclasses.replace(self, data=self.data.to(device))

    def detached(self) -> "DenseGrid":
        """The grid with its array detached from autograd (contiguous)."""
        return dataclasses.replace(self, data=self.data.detach().contiguous())

    def world_to_index(self, p_world: torch.Tensor) -> torch.Tensor:
        """(p_world - world_offset) / voxel_size, a true float32 division as
        in the JAX package and the kernels' init_lane. The voxel size is a
        tensor on the points' device: torch's CUDA division by a host scalar
        (a Python float or a 0-dim CPU tensor) multiplies by the reciprocal,
        which differs in the last bit where the voxel size is not a power of
        two."""
        t = torch.tensor((*self.world_offset, self.voxel_size), dtype=torch.float32, device=p_world.device)
        return (p_world - t[:3]) / t[3]

    def index_to_world(self, p_index: torch.Tensor) -> torch.Tensor:
        off = torch.tensor(self.world_offset, dtype=torch.float32, device=p_index.device)
        return p_index * self.voxel_size + off


def dense_grid_from_array(
    data,
    origin_ijk=(0, 0, 0),
    voxel_size: float = 1.0,
    world_offset=(0.0, 0.0, 0.0),
) -> DenseGrid:
    """A DenseGrid over `data` (numpy array or tensor; kept on its device,
    numpy on the CPU). Medium.from_grids moves grids to the render device."""
    if isinstance(data, torch.Tensor):
        t = data.to(torch.float32).contiguous()
    else:
        a = np.ascontiguousarray(data, dtype=np.float32)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return DenseGrid(
        data=t,
        origin_ijk=tuple(int(v) for v in origin_ijk),
        voxel_size=float(voxel_size),
        world_offset=tuple(float(v) for v in world_offset),
    )


def gather_voxels(data: torch.Tensor, ijk: torch.Tensor) -> torch.Tensor:
    """Voxels at integer local coords ijk [..., 3]; 0 outside the array."""
    X, Y, Z = data.shape
    i, j, k = ijk[..., 0], ijk[..., 1], ijk[..., 2]
    valid = (i >= 0) & (i < X) & (j >= 0) & (j < Y) & (k >= 0) & (k < Z)
    flat_idx = (
        torch.clamp(i, 0, X - 1) * Y + torch.clamp(j, 0, Y - 1)
    ) * Z + torch.clamp(k, 0, Z - 1)
    vals = data.reshape(-1)[flat_idx]
    return torch.where(valid, vals, 0.0)


_CORNER_OFFSETS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def trilinear_weights(f: torch.Tensor) -> torch.Tensor:
    """The 8 corner weights [..., 8] for fractional coords f [..., 3], in the
    corner order of pack_corner_rows (z fastest)."""
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    return torch.stack(
        [
            gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
            fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz,
        ],
        dim=-1,
    )


def dot8(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum(v * w) over the last axis (8 wide), added left to right.

    A fixed order so the plain version and the CUDA kernel add the same
    terms in the same sequence.
    """
    p = v * w
    s = p[..., 0]
    for c in range(1, 8):
        s = s + p[..., c]
    return s


def sample_trilinear_local(data: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of `data` [X, Y, Z] at float local coords p [..., 3]."""
    i0 = torch.floor(p).to(torch.int64)
    f = p - i0.to(p.dtype)
    offs = torch.tensor(_CORNER_OFFSETS, dtype=torch.int64, device=p.device)
    v = gather_voxels(data, i0[..., None, :] + offs)  # [..., 8]
    return dot8(v, trilinear_weights(f))


def pack_corner_rows(data: torch.Tensor, padded: bool = False) -> torch.Tensor:
    """Corner-packed layout [(X+1)(Y+1)(Z+1), 8]: row r holds the 2x2x2
    neighborhood of base voxel r (base coords -1..dim-1 per axis, flat
    order, z fastest), so every query point in [-1, dim] interpolates with
    zero background.

    padded=True: `data` already carries values at coords -1..dim per axis
    (shape [X+2, Y+2, Z+2]) and is used as-is instead of zero-padding.

    Built column by column into one preallocated table: each of the 8 corner
    offsets is one strided copy of a shifted view, so the peak is the table
    plus the padded grid (the JAX package builds large tables one x-slab at
    a time for the same reason; a 512^3 grid makes a 4.3 GB table).
    """
    return _pack_columns(data, padded, width=8)


def _pack_columns(data: torch.Tensor, padded: bool, width: int, extra_rows: int = 0,
                  out: torch.Tensor = None, col0: int = 0) -> torch.Tensor:
    if padded:
        X, Y, Z = (s - 2 for s in data.shape)
        p = data
    else:
        X, Y, Z = data.shape
        p = torch.nn.functional.pad(data[None, None], (1, 1, 1, 1, 1, 1))[0, 0]
    n = (X + 1) * (Y + 1) * (Z + 1)
    if out is None:
        out = torch.zeros((n + extra_rows, width), dtype=torch.float32, device=data.device)
    view = out[:n].view(X + 1, Y + 1, Z + 1, width)
    for c, (dx, dy, dz) in enumerate(_CORNER_OFFSETS):
        view[..., col0 + c] = p[dx:dx + X + 1, dy:dy + Y + 1, dz:dz + Z + 1]
    return out


def corner_row_index(shape, i0: torch.Tensor):
    """(row index, validity) of base coord i0 [..., 3] in a corner-packed
    table. Out-of-range coords clamp (the caller masks with `valid`)."""
    X, Y, Z = shape
    ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
    valid = (
        (ix >= -1) & (ix <= X - 1)
        & (iy >= -1) & (iy <= Y - 1)
        & (iz >= -1) & (iz <= Z - 1)
    )
    rx = torch.clamp(ix + 1, 0, X)
    ry = torch.clamp(iy + 1, 0, Y)
    rz = torch.clamp(iz + 1, 0, Z)
    base = (rx * (Y + 1) + ry) * (Z + 1) + rz
    return base, valid


def sample_trilinear_rows(rows: torch.Tensor, shape, p: torch.Tensor) -> torch.Tensor:
    """Trilinear sample from a corner-packed table at local coords p [..., 3]
    (zero background outside the volume); only the first 8 columns are read."""
    i0 = torch.floor(p).to(torch.int64)
    f = p - i0.to(p.dtype)
    base, valid = corner_row_index(shape, i0)
    v = rows[torch.clamp(base, 0, rows.shape[0] - 1)][..., :8]
    return torch.where(valid, dot8(v, trilinear_weights(f)), 0.0)
