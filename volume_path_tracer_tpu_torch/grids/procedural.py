"""Procedural volume fixtures: asset-free volumes for tests and benchmarks.

numpy copies of volume_path_tracer_tpu/grids/procedural.py (the port imports
nothing of the JAX package): the same generators with the same seeds give
the same float32 voxels. The reference renderer ships generate_donut()
wrapping NanoVDB's createFogVolumeTorus as its synthetic fixture; a fire-like
fixture with a correlated temperature field makes the emissive path
testable, and big_cloud is a production-scale (512^3) stand-in for the
wdas_cloud asset.

Generators run on the host and return DenseGrids on the CPU;
Medium.from_grids moves them to the render device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .grid import DenseGrid, dense_grid_from_array


def _smoothstep(e0, e1, x):
    t = np.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def fog_torus(
    major_radius: float = 20.0,
    minor_radius: float = 8.0,
    falloff: float = 3.0,
    voxel_size: float = 1.0,
    world_offset=(0.0, 0.0, 0.0),
) -> DenseGrid:
    """A fog torus in the xz plane centered at the grid center ("the donut").

    Density 1 inside the tube, smooth falloff of width `falloff` voxels at the
    surface — the same shape family as NanoVDB's createFogVolumeTorus.
    """
    r = int(np.ceil(major_radius + minor_radius + falloff)) + 2
    n = 2 * r + 1
    i = np.arange(n, dtype=np.float32) - r
    x, y, z = np.meshgrid(i, i, i, indexing="ij")
    q = np.sqrt(x * x + z * z) - major_radius
    dist = np.sqrt(q * q + y * y) - minor_radius  # signed distance to tube surface
    density = np.clip(-dist / falloff, 0.0, 1.0).astype(np.float32)
    return dense_grid_from_array(
        density, origin_ijk=(-r, -r, -r), voxel_size=voxel_size, world_offset=world_offset
    )


def generate_donut() -> DenseGrid:
    """Parity alias for VolumeGrids::generate_donut (volume_grids.cpp:35-37)."""
    return fog_torus()


def fog_sphere(
    radius: float = 16.0,
    falloff: float = 3.0,
    voxel_size: float = 1.0,
    world_offset=(0.0, 0.0, 0.0),
) -> DenseGrid:
    r = int(np.ceil(radius + falloff)) + 2
    n = 2 * r + 1
    i = np.arange(n, dtype=np.float32) - r
    x, y, z = np.meshgrid(i, i, i, indexing="ij")
    dist = np.sqrt(x * x + y * y + z * z) - radius
    density = np.clip(-dist / falloff, 0.0, 1.0).astype(np.float32)
    return dense_grid_from_array(
        density, origin_ijk=(-r, -r, -r), voxel_size=voxel_size, world_offset=world_offset
    )


def fire_plume(
    height: int = 64,
    radius: float = 14.0,
    voxel_size: float = 1.0,
    seed: int = 0,
) -> Tuple[DenseGrid, DenseGrid]:
    """A smoke/fire plume: (density, temperature) grids with distinct transforms.

    The temperature grid deliberately gets its own index transform (a shifted
    world_offset), exercising the reference's behavior of mapping collision
    points through the temperature grid's own map (worker.cpp:153).
    Temperature is in the grid's "adimensional" units; the scene config maps it
    to kelvin via temperature_scale/offset.
    """
    rng = np.random.default_rng(seed)
    rad = int(np.ceil(radius)) + 2
    nx = nz = 2 * rad + 1
    ny = height
    ix = np.arange(nx, dtype=np.float32) - rad
    iy = np.arange(ny, dtype=np.float32)
    iz = np.arange(nz, dtype=np.float32) - rad
    x, y, z = np.meshgrid(ix, iy, iz, indexing="ij")
    # Tapering cylinder with noise modulation.
    taper = 1.0 - 0.6 * (y / height)
    rr = np.sqrt(x * x + z * z) / (radius * np.maximum(taper, 0.2))
    base = np.clip(1.0 - rr, 0.0, 1.0)
    vertical = _smoothstep(0.0, 5.0, y) * (1.0 - _smoothstep(0.7 * height, height, y))
    noise = rng.uniform(0.6, 1.0, size=base.shape).astype(np.float32)
    density = (base * vertical * noise).astype(np.float32)
    # Hot core: temperature peaks near the axis and the bottom.
    temp = (base**2) * (1.0 - 0.8 * (y / height)) * 30.0
    temp = temp.astype(np.float32)

    dgrid = dense_grid_from_array(
        density, origin_ijk=(-rad, 0, -rad), voxel_size=voxel_size,
        world_offset=(0.0, 0.0, 0.0),
    )
    # The temperature grid gets a deliberately different transform (half-voxel
    # world shift) so the separate world->index mapping path is exercised.
    tgrid = dense_grid_from_array(
        temp, origin_ijk=(-rad, 0, -rad), voxel_size=voxel_size,
        world_offset=(0.5 * voxel_size, 0.0, 0.5 * voxel_size),
    )
    return dgrid, tgrid


def big_cloud(
    n: int = 512,
    seed: int = 7,
    occupancy_target: float = 0.12,
    voxel_size: float = 1.0,
) -> DenseGrid:
    """A wdas_cloud-scale sparse cumulus stand-in: [n, n, n] float density.

    Stands in for the flagship asset (wdas_cloud.nvdb, the public Disney
    cloud) without needing it: a structurally comparable volume, hundreds of
    voxels across, ~10-15% active occupancy in puffy lobes with empty space
    around them, so production-scale memory and throughput behavior
    (device-resident grids, majorant skipping over real emptiness, packed-row
    table cost) is measurable. Built from value-noise octaves shaped by a
    union of ellipsoidal lobes; pure numpy.
    """
    rng = np.random.default_rng(seed)

    def value_noise(shape, cells):
        g = rng.standard_normal((cells + 1,) * 3).astype(np.float32)
        idx = [np.linspace(0, cells, s, endpoint=False) for s in shape]
        i0 = [np.floor(v).astype(np.int32) for v in idx]
        f = [v - w for v, w in zip(idx, i0)]
        f = [t * t * (3.0 - 2.0 * t) for t in f]
        x0, y0, z0 = np.meshgrid(*i0, indexing="ij", sparse=True)
        fx, fy, fz = np.meshgrid(*f, indexing="ij", sparse=True)

        def corner(dx, dy, dz):
            return g[x0 + dx, y0 + dy, z0 + dz]

        return (
            corner(0, 0, 0) * (1 - fx) * (1 - fy) * (1 - fz)
            + corner(0, 0, 1) * (1 - fx) * (1 - fy) * fz
            + corner(0, 1, 0) * (1 - fx) * fy * (1 - fz)
            + corner(0, 1, 1) * (1 - fx) * fy * fz
            + corner(1, 0, 0) * fx * (1 - fy) * (1 - fz)
            + corner(1, 0, 1) * fx * (1 - fy) * fz
            + corner(1, 1, 0) * fx * fy * (1 - fz)
            + corner(1, 1, 1) * fx * fy * fz
        ).astype(np.float32)

    shape = (n, n, n)
    noise = (
        value_noise(shape, 6)
        + 0.5 * value_noise(shape, 12)
        + 0.25 * value_noise(shape, 24)
    )

    # Puffy lobes: a union of soft ellipsoids clustered around the center.
    ax = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij", sparse=True)
    body = np.full(shape, -1.0, np.float32)
    for _ in range(10):
        c = rng.uniform(-0.45, 0.45, 3).astype(np.float32)
        r = rng.uniform(0.18, 0.4, 3).astype(np.float32)
        d = (
            ((x - c[0]) / r[0]) ** 2
            + ((y - c[1]) / r[1]) ** 2
            + ((z - c[2]) / r[2]) ** 2
        )
        body = np.maximum(body, (1.0 - d).astype(np.float32))

    field = body + 0.55 * noise
    # Choose the iso threshold to hit the requested occupancy.
    thresh = np.quantile(field, 1.0 - occupancy_target)
    density = np.clip((field - thresh) * 2.5, 0.0, 1.0).astype(np.float32)
    h = n // 2
    return dense_grid_from_array(
        density, origin_ijk=(-h, -h, -h), voxel_size=voxel_size
    )
