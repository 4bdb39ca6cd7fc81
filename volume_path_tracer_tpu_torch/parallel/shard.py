"""Multi-GPU rendering: rays and samples sharded over a ('rays', 'spp') mesh.

Port of volume_path_tracer_tpu/parallel/shard.py on PyTorch. A Mesh is an
[R, S] array of cells, each a torch.device owned by one process; a device
may hold several cells (the tests lay 8 cells on the CPU, chip_smoke.py
several on one card, the counterpart of the JAX tests' virtual devices):

  - 'rays': the ray batch is split into R contiguous shards, one for each
    row of the mesh (the reference renderer's tile ownership);
  - 'spp': the S cells of a row render S waves of the same pixels at once,
    global wave wave * S + spp_index, and their contributions are summed;
  - the medium, camera and blackbody table are copied to each cell's device
    once (to_device); the forward pass needs no other communication.

Every draw is keyed on the global pixel id and the global wave (utils/
rng.py), so a film sharded over 'rays' is bitwise the one-device film on
any mesh shape, and one sharded over 'spp' equals sequential waves up to
the rounding of the sum.

Each cell renders through megakernel.render_wave, the main path's wrapper:
on a CUDA device the wave kernel over the shard's pixel range, on the CPU
its plain version. Under torch.distributed (parallel/multihost.py) a process
renders only its own cells: its contribution holds the rows of those cells,
and multihost.gather_film_to_host sums the processes' films.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.camera import Camera
from ..models.medium import Medium
from ..render.integrator import IntegratorParams
from ..render.megakernel import render_wave
from ..utils import rng as vrng
from ..utils.device import resolve_device, same_device
from ..utils.spans import span


def process_rank() -> int:
    """This process's rank in the torch.distributed job (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ('rays', 'spp') mesh of cells.

    devices: [R, S] object array of torch.device. ranks: [R, S] int array,
    the rank of the process that owns each cell (multihost.global_mesh), or
    None when this process owns every cell (make_mesh).
    """

    devices: np.ndarray
    ranks: Optional[np.ndarray] = None

    @property
    def shape(self) -> dict:
        return {"rays": self.devices.shape[0], "spp": self.devices.shape[1]}

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def spans_processes(self) -> bool:
        """Whether cells belong to more than one process: sums over cells
        then cross processes (torch.distributed.all_reduce)."""
        return self.ranks is not None and len(np.unique(self.ranks)) > 1

    def local_cells(self) -> List[Tuple[int, int, torch.device]]:
        """(rays index, spp index, device) of this process's cells, row-major."""
        me = process_rank()
        R, S = self.devices.shape
        return [(r, s, self.devices[r, s]) for r in range(R) for s in range(S)
                if self.ranks is None or self.ranks[r, s] == me]

    @property
    def home(self) -> torch.device:
        """The device of this process's first cell: where sums over its cells
        and the results of the sharded calls live."""
        return self.local_cells()[0][2]


def make_mesh(n_devices: Optional[int] = None, spp: int = 1, devices=None) -> Mesh:
    """A ('rays', 'spp') mesh over the first n_devices of `devices` (default:
    every visible CUDA device; raises where there is none). `devices` may
    repeat a device, to lay several cells on it (["cpu"] * 8)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=['cpu'] * n to lay the mesh "
                               "on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    n = n_devices or len(devs)
    if not 1 <= n <= len(devs):
        raise ValueError(f"a mesh of {n} cells over {len(devs)} device(s)")
    if n % spp:
        raise ValueError(f"{n} cells do not split into an 'spp' axis of {spp}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(n // spp, spp))


def pad_ray_batch(width: int, height: int, n_align: int):
    """Row-major pixel (coords [N, 2], ids [N], npix), numpy int32, padded to
    a multiple of n_align. Padding lanes take the coordinate (0, 0) and the
    out-of-image pixel id `npix`: render_wave_sharded leaves them out of the
    launches (a film on the card is written in place), and callers slice
    the contribution at [:npix]."""
    npix = width * height
    pad = (-npix) % n_align
    ys, xs = np.mgrid[0:height, 0:width]
    raster = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)
    pids = np.arange(npix, dtype=np.int32)
    if pad:
        raster = np.concatenate([raster, np.zeros((pad, 2), np.int32)])
        pids = np.concatenate([pids, np.full((pad,), npix, np.int32)])
    return raster, pids, npix


def tree_sum(xs):
    """Sum in a fixed pairwise order, ((x0 + x1) + (x2 + x3)) + ...: sums over
    cells that a process takes in groups of a power of two, then adds across
    processes, round the same way as one process's sum over all cells."""
    xs = list(xs)
    while len(xs) > 1:
        xs = [xs[i] + xs[i + 1] if i + 1 < len(xs) else xs[i] for i in range(0, len(xs), 2)]
    return xs[0]


# (id(obj), device) -> (weak reference to obj, its copy on the device)
_COPIES = {}


def to_device(obj, device):
    """`obj` (a Medium, a Camera, a tensor or None) on `device`: itself where
    it lives there, else a copy made at first use and kept while `obj`
    lives, so that every wave of a cell meets the same copy (and the kernel
    constants kept for it). A Medium keeps its form (Medium.to): packed
    tables, or the grids alone."""
    if obj is None:
        return None
    if not isinstance(obj, (Medium, Camera, torch.Tensor)):
        raise TypeError(f"to_device: cannot copy a {type(obj).__name__}")
    dev = torch.device(device)
    if same_device(obj.device, dev):
        return obj
    key = (id(obj), str(dev))
    hit = _COPIES.get(key)
    if hit is not None and hit[0]() is obj:
        return hit[1]
    with span("shard.copy"):
        copy = obj.to(dev)
    _COPIES[key] = (weakref.ref(obj), copy)
    weakref.finalize(obj, _COPIES.pop, key, None)
    return copy


class _Shard(NamedTuple):
    rows: slice  # the batch's rows of the shard's in-image lanes
    pixels: range  # their pixel ids


class _RayPlan(NamedTuple):
    width: int
    height: int
    shards: List[_Shard]


# (id(raster_xy), id(pixel_ids), shards) -> (weak references, _RayPlan)
_PLANS = {}


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def ray_plan(raster_xy, pixel_ids, n_shards: int) -> _RayPlan:
    """What each 'rays' shard renders of a ray batch: the film's width and
    height, and per shard the rows of its in-image lanes and their pixel ids,
    both contiguous ranges (the wave kernel's fast form). The batch is that
    of whole rows of a film in order, padded at its end (pad_ray_batch,
    multihost.make_global_ray_batch): the width is the largest x + 1, and a
    lane whose id is below width * height must be the pixel y * width + x,
    each at most once; a lane with a larger id is padding. A shard whose
    in-image lanes are not one run of consecutive pixels is refused. Made
    once for each pair of arrays and kept while they live."""
    key = (id(raster_xy), id(pixel_ids), n_shards)
    hit = _PLANS.get(key)
    if hit is not None and hit[0][0]() is raster_xy and hit[0][1]() is pixel_ids:
        return hit[1]
    xy = _host(raster_xy).astype(np.int64)
    ids = _host(pixel_ids).astype(np.int64)
    n = ids.shape[0]
    if xy.shape != (n, 2) or n == 0:
        raise ValueError(f"raster_xy {xy.shape} and pixel_ids {ids.shape} are not one ray batch")
    if n % n_shards:
        raise ValueError(f"{n} rays do not split into {n_shards} shards (pad_ray_batch pads them)")
    width, height = int(xy[:, 0].max()) + 1, int(xy[:, 1].max()) + 1
    real = ids < width * height
    if (ids < 0).any() or not np.array_equal(ids[real], xy[real, 1] * width + xy[real, 0]):
        raise ValueError("pixel_ids are not the row-major ids of raster_xy in a film of its width")
    if np.unique(ids[real]).size != int(real.sum()):
        raise ValueError("a pixel id occurs twice in the ray batch")
    per = n // n_shards
    shards = []
    for r in range(n_shards):
        rows = np.flatnonzero(real[r * per:(r + 1) * per]) + r * per
        pix = ids[rows]
        if not rows.size:
            shards.append(_Shard(slice(0, 0), range(0)))
        elif (np.diff(rows) == 1).all() and (np.diff(pix) == 1).all():
            shards.append(_Shard(slice(int(rows[0]), int(rows[-1]) + 1), range(int(pix[0]), int(pix[-1]) + 1)))
        else:
            raise ValueError(f"shard {r}'s pixels are not one run of consecutive pixels in consecutive rows "
                             "(pad_ray_batch's order)")
    plan = _RayPlan(width, height, shards)
    try:
        refs = (weakref.ref(raster_xy), weakref.ref(pixel_ids))
    except TypeError:  # an array type without weak references: not kept
        return plan
    _PLANS[key] = (refs, plan)
    weakref.finalize(raster_xy, _PLANS.pop, key, None)
    return plan


def render_wave_sharded(
    mesh: Mesh,
    medium: Medium,
    params: IntegratorParams,
    camera: Camera,
    bb_table: Optional[torch.Tensor],
    raster_xy,
    pixel_ids,
    seed: int,
    wave: int,
    use_jitter: bool,
    return_lane_iters: bool = False,
):
    """One sharded wave: returns (contribution [N, 4], n_capped, iters), plus
    the lane-iterations when return_lane_iters, the counts as 0-d int64
    tensors on mesh.home.

    raster_xy [N, 2] and pixel_ids [N] (numpy or tensors; N a multiple of
    the 'rays' axis) are a whole-row ray batch as ray_plan describes. Each
    cell (r, s) renders shard r at global wave wave * S + s into a film of
    its own 'spp' index on its device; the contribution's rows are the sum
    over 'spp' of those films' rows (tree_sum), so one call adds S samples
    to every pixel. Padding rows stay zero. n_capped, iters (each cell's
    largest lane counter) and lane_iters (integrator.lane_iterations, the
    same on any mesh) are summed over every cell, across processes too;
    the contribution holds this process's cells' rows
    (multihost.gather_film_to_host sums the processes').
    """
    with span("shard.wave"):
        S = mesh.shape["spp"]
        plan = ray_plan(raster_xy, pixel_ids, mesh.shape["rays"])
        home = mesh.home
        films, counts, rows_of = {}, [], {}
        for r, s, dev in mesh.local_cells():
            with span("shard.cell"):
                shard = plan.shards[r]
                key = (str(dev), s)
                if key not in films:
                    films[key] = torch.zeros((plan.height, plan.width, 4), dtype=torch.float32, device=dev)
                rows_of.setdefault(r, []).append(key)
                if not len(shard.pixels):
                    continue
                stream = vrng.mix_stream(seed, (wave * S + s) & 0xFFFFFFFF)
                out = render_wave(to_device(medium, dev), params, to_device(camera, dev), to_device(bb_table, dev),
                                  films[key], shard.pixels, stream, use_jitter, camera.imaging_ratio,
                                  return_lane_iters=return_lane_iters)
                counts.append(torch.stack([out[1].to(torch.int64), out[0].to(torch.int64), *out[2:]]).to(home))
        with span("shard.gather"):
            contrib = torch.zeros((len(pixel_ids), 4), dtype=torch.float32, device=home)
            for r, keys in rows_of.items():
                shard = plan.shards[r]
                if len(shard.pixels):
                    contrib[shard.rows] = tree_sum(films[k].view(-1, 4)[shard.pixels.start:shard.pixels.stop]
                                                   .to(home) for k in keys)
            total = torch.stack(counts).sum(0) if counts else torch.zeros(2 + return_lane_iters, dtype=torch.int64,
                                                                           device=home)
            if mesh.spans_processes:
                dist.all_reduce(total)
        return (contrib, *total.unbind())


def render_film_sharded(
    mesh: Mesh,
    medium: Medium,
    params: IntegratorParams,
    camera: Camera,
    bb_table: Optional[torch.Tensor],
    width: int,
    height: int,
    seed: int,
    num_waves: int,
    use_jitter: bool = True,
    wave_callback=None,
) -> torch.Tensor:
    """A whole sharded render: returns the film [H, W, 4] on mesh.home.

    Waves advance in strides of the 'spp' axis (each call adds S samples a
    pixel), wave 1 + w0 // S for w0 = 0, S, 2S, ...; the pixel count is padded
    to the 'rays' axis. wave_callback(waves_done, film) runs after each call;
    returning False stops. Under torch.distributed the film holds this
    process's cells' rows (multihost.gather_film_to_host).
    """
    S = mesh.shape["spp"]
    raster, pids, npix = pad_ray_batch(width, height, mesh.shape["rays"])
    film = torch.zeros((raster.shape[0], 4), dtype=torch.float32, device=mesh.home)
    for w0 in range(0, num_waves, S):
        contrib, _, _ = render_wave_sharded(mesh, medium, params, camera, bb_table, raster, pids, seed,
                                            1 + w0 // S, use_jitter)
        film = film + contrib
        if wave_callback is not None and wave_callback(w0 + S, film[:npix].reshape(height, width, 4)) is False:
            break
    return film[:npix].reshape(height, width, 4)
