"""Medium (participating volume): grids + majorants + the fused row table.

Port of volume_path_tracer_tpu/models/medium.py:

  - density: DenseGrid (required)
  - temperature: DenseGrid or None (None -> a non-emissive medium)
  - majorants: MajorantPyramid over density
  - density_rows: the fused table [(X+1)(Y+1)(Z+1) + NB, 8 or 16]: corner
    rows, then per-brick (brick, superbrick) majorant rows. One row read per
    lane-step serves either a trilinear sample or a segment's majorants.
    16-wide rows carry an alignment-compatible temperature grid's corners in
    columns 8..15.
  - temperature_rows: corner rows of a temperature grid that could not be
    folded (its own transform, 8-wide density rows), else None.

All tensors of a Medium live on one device, chosen at Medium.from_grids.
Whether a volume takes the fused table (pack=True) or is read from its own
dense arrays (pack=False) is decided in one place, choose_pack: the table is
eight times the grid, and a volume whose table does not fit on the device,
or has 2^31 rows or more, is rendered from its arrays.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..grids.grid import DenseGrid, _pack_columns, dense_grid_from_array, pack_corner_rows
from ..grids.majorant import BRICK, SUPER, MajorantPyramid, build_majorants
from ..utils.device import DeviceLike, resolve_device, same_device
from ..utils.spans import span


def temperature_on_density_grid(density: DenseGrid, temperature: Optional[DenseGrid]):
    """Temperature resampled onto the density grid's frame, or None.

    Returns [X+2, Y+2, Z+2] T with T[q + 1] = the temperature grid's value
    at density voxel coordinate q for q in -1..X per axis (the corner-table
    extent). Exact when the grids are alignment-compatible (same voxel size,
    integer index offset between frames): trilinear interpolation of these
    corners then equals the own-transform temperature sample at every
    collision point. None for misaligned grids (the caller keeps the
    separate temperature-row gather).
    """
    delta = _index_offset(density, temperature)
    if delta is None:
        return None
    X, Y, Z = density.shape
    tX, tY, tZ = temperature.shape
    lo = [max(0, 1 - d) for d in delta]
    hi = [min(s + 2, ts + 1 - d) for s, ts, d in zip((X, Y, Z), (tX, tY, tZ), delta)]
    out = torch.zeros((X + 2, Y + 2, Z + 2), dtype=torch.float32, device=density.device)
    if any(h <= l for l, h in zip(lo, hi)):
        return out  # disjoint bboxes: temperature is background 0 everywhere
    out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = temperature.data[
        lo[0] - 1 + delta[0]:hi[0] - 1 + delta[0],
        lo[1] - 1 + delta[1]:hi[1] - 1 + delta[1],
        lo[2] - 1 + delta[2]:hi[2] - 1 + delta[2],
    ]
    return out


def _index_offset(density: DenseGrid, temperature: Optional[DenseGrid]):
    """The integer offset from the density grid's index frame to the
    temperature grid's, or None (no temperature, or grids that are not
    alignment-compatible: another voxel size or a fractional offset). Reads
    the transforms only."""
    if temperature is None:
        return None
    vd, vt = density.voxel_size, temperature.voxel_size
    if abs(vt - vd) > 1e-9 * max(vd, vt):
        return None
    delta = []
    for a in range(3):
        dw = (
            density.origin_ijk[a] * vd
            + density.world_offset[a]
            - temperature.world_offset[a]
        ) / vt - temperature.origin_ijk[a]
        r = round(dw)
        if abs(dw - r) > 1e-4:
            return None
        delta.append(int(r))
    return delta


def pack_fused_rows(data: torch.Tensor, pyr: MajorantPyramid, temp_on_density=None) -> torch.Tensor:
    """The integrator's hot-path table [(X+1)(Y+1)(Z+1) + NB, 8 or 16].

    Corner rows of `data` (columns 0..7), the padded temperature's corner
    rows when given (columns 8..15), then the majorant rows (brick,
    superbrick, zero-padded). Written into one preallocated table.
    """
    width = 8 if temp_on_density is None else 16
    nb = pyr.rows.shape[0]
    out = _pack_columns(data, padded=False, width=width, extra_rows=nb)
    if temp_on_density is not None:
        _pack_columns(temp_on_density, padded=True, width=width, out=out, col0=8)
    out[out.shape[0] - nb:, :2] = pyr.rows
    return out


@dataclasses.dataclass(frozen=True)
class Medium:
    density: DenseGrid
    majorants: MajorantPyramid
    temperature: Optional[DenseGrid] = None
    density_rows: Optional[torch.Tensor] = None
    temperature_rows: Optional[torch.Tensor] = None

    @property
    def has_temperature(self) -> bool:
        return self.temperature is not None

    @property
    def device(self) -> torch.device:
        return self.density.device

    @property
    def form(self) -> str:
        """The form the kernels read: "packed" (the fused table) or "dense"
        (the grids' own arrays)."""
        return "packed" if self.density_rows is not None else "dense"

    @property
    def resident_bytes(self) -> int:
        """Bytes the medium holds on its device: grids, majorants and tables,
        each storage counted once."""
        m = self.majorants
        held = (self.density.data, self.temperature.data if self.temperature is not None else None,
                m.brick_maj, m.super_maj, m.rows, self.density_rows, self.temperature_rows)
        storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in held if t is not None}
        return sum(storages.values())

    def to(self, device) -> "Medium":
        """The medium on `device` (itself when it is there already): the
        grids and every table copied."""
        dev = torch.device(device)
        if same_device(self.device, dev):
            return self

        def move(t):
            return None if t is None else t.to(dev)

        m = self.majorants
        return Medium(
            density=self.density.to(dev),
            majorants=dataclasses.replace(m, brick_maj=move(m.brick_maj), super_maj=move(m.super_maj),
                                          rows=move(m.rows)),
            temperature=self.temperature.to(dev) if self.temperature is not None else None,
            density_rows=move(self.density_rows),
            temperature_rows=move(self.temperature_rows),
        )

    @staticmethod
    def from_grids(
        density: DenseGrid,
        temperature: Optional[DenseGrid] = None,
        order: int = 1,
        pack: bool = True,
        fuse_temperature: bool = True,
        device: DeviceLike = None,
    ) -> "Medium":
        """Build a medium on `device` (CUDA unless device="cpu"), computing
        majorants and, with pack=True, the fused row table (choose_pack
        says whether a volume's table fits)."""
        with span("medium.build"):
            dev = resolve_device(device)
            density = density.to(dev)
            temperature = temperature.to(dev) if temperature is not None else None
            majorants = build_majorants(density, order=order)
            t_on_d = (
                temperature_on_density_grid(density, temperature)
                if (pack and fuse_temperature)
                else None
            )
            rows = pack_fused_rows(density.data, majorants, t_on_d) if pack else None
            # The separate temperature table is read only when the temperature
            # is not folded into the fused rows.
            trows = (
                pack_corner_rows(temperature.data)
                if (pack and temperature is not None and t_on_d is None)
                else None
            )
            return Medium(
                density=density,
                majorants=majorants,
                temperature=temperature,
                density_rows=rows,
                temperature_rows=trows,
            )


# Row numbers of the fused table are 32-bit in the kernels: render/megakernel.py
# refuses a table of this many rows or more.
MAX_TABLE_ROWS = 2**31
# One wave's working set a pixel beside the medium: the film and the
# renderer's new film ([H, W, 4] float32 each) and a lane's SoA state (21
# floats and 3 ints) where a wave goes through trace_lanes.
WAVE_BYTES_PER_PIXEL = 2 * 16 + 24 * 4


def free_bytes_on(device: torch.device) -> Optional[int]:
    """The device's free memory: what CUDA reports, or on the CPU the
    host's available physical memory (None where the system does not say)."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return None


def packed_bytes(density: DenseGrid, temperature: Optional[DenseGrid] = None):
    """What Medium.from_grids(pack=True) makes of these grids on a device:
    (rows, held, peak). rows: the most rows of one of its tables; held: the
    bytes the medium then holds (grids, majorants, tables); peak: at most the
    bytes its build holds at once, held plus the packer's copies.

    The fused table is (X+1)(Y+1)(Z+1) corner rows plus one majorant row a
    brick, 8 floats a row, 16 with an alignment-compatible temperature fused;
    a temperature that is not has its own 8-wide corner rows. While a table
    fills, _pack_columns holds the zero-padded [X+2, Y+2, Z+2] copy of its
    grid, and a fused temperature's [X+2, Y+2, Z+2] array
    (temperature_on_density_grid) lives through the whole fill. Reads the
    grids' shapes and transforms, never their data: `meta` tensors do.
    """
    X, Y, Z = density.shape
    bricks = [-(-n // BRICK) for n in (X, Y, Z)]
    n_bricks = bricks[0] * bricks[1] * bricks[2]
    n_supers = 1
    for b in bricks:
        n_supers *= -(-b // SUPER)
    fused = _index_offset(density, temperature) is not None
    rows = (X + 1) * (Y + 1) * (Z + 1) + n_bricks
    held = rows * (16 if fused else 8) * 4 + X * Y * Z * 4 + (3 * n_bricks + n_supers) * 4
    padded = (X + 2) * (Y + 2) * (Z + 2) * 4
    copies = 2 * padded if fused else padded
    if temperature is not None:
        TX, TY, TZ = temperature.shape
        held += TX * TY * TZ * 4
        if not fused:
            trows = (TX + 1) * (TY + 1) * (TZ + 1)
            rows = max(rows, trows)
            held += trows * 8 * 4
            # the density's padded copy is gone when the temperature's is made
            copies = max(copies, (TX + 2) * (TY + 2) * (TZ + 2) * 4)
    return rows, held, held + copies


def choose_pack(
    density: DenseGrid,
    temperature: Optional[DenseGrid] = None,
    device: DeviceLike = None,
    pixels: int = 0,
) -> bool:
    """Medium.from_grids' `pack` for these grids on `device`.

    True (the fused table) when its tables have fewer than 2^31 rows each
    and the device's free memory (free_bytes_on, read before the grids are
    on it) holds the packed build's peak, and the packed medium beside one
    wave's working set over `pixels` (packed_bytes); else False (the kernels
    read the grids' own dense arrays, an eighth of the table's bytes). Where
    the free memory is unknown only the row limit applies.
    """
    rows, held, peak = packed_bytes(density, temperature)
    if rows >= MAX_TABLE_ROWS:
        return False
    free = free_bytes_on(resolve_device(device))
    return free is None or max(peak, held + pixels * WAVE_BYTES_PER_PIXEL) <= free


def _grid_from_numpy(g) -> DenseGrid:
    """A DenseGrid from an object with data, origin_ijk, voxel_size and
    world_offset attributes (a JAX DenseGrid qualifies)."""
    return dense_grid_from_array(
        np.asarray(g.data, dtype=np.float32), g.origin_ijk, g.voxel_size, g.world_offset
    )


def medium_from_numpy(density, temperature=None, device: DeviceLike = None, **kwargs) -> Medium:
    """Medium.from_grids over grids given as numpy arrays plus transforms.

    density / temperature: objects with `data` ([X, Y, Z] array),
    `origin_ijk`, `voxel_size` and `world_offset` attributes (the JAX
    package's DenseGrid fields). kwargs go to Medium.from_grids (order, pack,
    fuse_temperature).
    """
    return Medium.from_grids(
        _grid_from_numpy(density),
        _grid_from_numpy(temperature) if temperature is not None else None,
        device=device,
        **kwargs,
    )
