"""Per-brick majorant hierarchy: empty-space skipping for delta tracking.

Port of volume_path_tracer_tpu/grids/majorant.py:
  - level 0 (brick, 8^3 voxels): max over each brick plus a 1-voxel halo
    (the trilinear stencil), so brick_maj >= the interpolated density
    everywhere inside the brick;
  - level 1 (superbrick, 8^3 bricks): max over brick majorants.

The brick max is separable: one 1-D windowed max per axis (window 8 + 2
halo, stride 8). Padding is -inf, `order` voxels at the low end and up to
the brick multiple plus `order` at the high end, then the result is clamped
at 0 (the background). F.max_pool3d pads symmetrically, so the windows are
explicit F.pad + unfold + amax.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from .grid import DenseGrid

BRICK = 8  # voxels per brick edge (the reference's VDB leaf DIM)
SUPER = 8  # bricks per superbrick edge


@dataclasses.dataclass(frozen=True)
class MajorantPyramid:
    brick_maj: torch.Tensor  # [BX, BY, BZ] float32
    super_maj: torch.Tensor  # [SX, SY, SZ] float32
    # [BX*BY*BZ, 2]: (brick majorant, superbrick majorant) per brick
    rows: torch.Tensor
    origin_ijk: Tuple[int, int, int]

    @property
    def brick_shape(self) -> Tuple[int, int, int]:
        return tuple(self.brick_maj.shape)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _window_max(x: torch.Tensor, axis: int, win: int, stride: int, pad_lo: int, pad_hi: int) -> torch.Tensor:
    """1-D max over windows of `win` with `stride` along `axis`, -inf padded."""
    pad = [0, 0] * 3
    # F.pad lists (lo, hi) pairs from the LAST axis backwards.
    pad[2 * (2 - axis)] = pad_lo
    pad[2 * (2 - axis) + 1] = pad_hi
    xp = F.pad(x, pad, value=float("-inf"))
    return xp.unfold(axis, win, stride).amax(dim=-1)


def build_majorants(grid: DenseGrid, order: int = 1, bloat: float = 0.0) -> MajorantPyramid:
    """Build the majorant pyramid for a density grid; gradients are cut
    (majorants are bounds, not integrands).

    order: the interpolation halo in voxels. bloat: multiplicative slack
    (1 + bloat) on the brick majorants, so on every nonzero one. Forward
    rendering wants 0 (fewest collisions); gradient rendering wants > 0: where
    the majorant equals the density, the null-collision probability is 0 and
    the score-function estimator of the transmittance gradient degenerates.
    """
    data = grid.data.detach()
    X, Y, Z = data.shape
    bx, by, bz = _ceil_div(X, BRICK), _ceil_div(Y, BRICK), _ceil_div(Z, BRICK)

    win = BRICK + 2 * order
    pad_hi = [bx * BRICK - X + order, by * BRICK - Y + order, bz * BRICK - Z + order]
    brick = data
    for axis, ph in enumerate(pad_hi):
        brick = _window_max(brick, axis, win, BRICK, order, ph)
    brick = torch.clamp(brick, min=0.0).contiguous()
    if bloat:
        brick = brick * (1.0 + bloat)

    sx, sy, sz = _ceil_div(bx, SUPER), _ceil_div(by, SUPER), _ceil_div(bz, SUPER)
    sp = F.pad(
        brick, [0, sz * SUPER - bz, 0, sy * SUPER - by, 0, sx * SUPER - bx],
        value=float("-inf"),
    )
    sup = sp.view(sx, SUPER, sy, SUPER, sz, SUPER).amax(dim=(1, 3, 5))
    sup = torch.clamp(sup, min=0.0)

    sup_per_brick = (
        sup.repeat_interleave(SUPER, 0)
        .repeat_interleave(SUPER, 1)
        .repeat_interleave(SUPER, 2)
    )[:bx, :by, :bz]
    rows = torch.stack([brick.reshape(-1), sup_per_brick.reshape(-1)], dim=-1)
    return MajorantPyramid(
        brick_maj=brick, super_maj=sup, rows=rows, origin_ijk=grid.origin_ijk
    )
