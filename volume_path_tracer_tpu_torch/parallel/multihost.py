"""Several processes: the process group, the global mesh, the film gather.

Port of volume_path_tracer_tpu/parallel/multihost.py on torch.distributed.
The recipe:

  1. every process calls `initialize()` (a torch.distributed process group
     over TCP: NCCL between cards, gloo on the CPU or, asked for, between
     processes that share a card);
  2. `global_mesh()` builds a ('rays', 'spp') mesh of every process's cells,
     each host's ranks together along 'spp', so that 'rays' spans hosts
     (pixel shards are independent: the forward pass sends nothing between
     processes);
  3. `make_global_ray_batch` gives every process the whole padded batch (it
     is cheap and the same everywhere); each renders only its own cells'
     shards;
  4. rendering and training run the same code as in one process
     (parallel/shard.py, diff/inverse.py): a process sums over its cells,
     then across processes with torch.distributed.all_reduce;
  5. `gather_film_to_host` sums the processes' films to process 0 for
     display and save.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device
from .shard import Mesh, pad_ray_batch, process_rank, to_device


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_rank(rank: Optional[int] = None) -> int:
    """This process's card on its host: LOCAL_RANK where the launcher sets
    it, else the rank modulo the visible CUDA devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_rank() if rank is None else rank
    return rank % max(torch.cuda.device_count(), 1)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceLike = None,
) -> None:
    """Join the torch.distributed job; nothing to do for a single process.

    coordinator_address: "host:port" of process 0 (TCP rendezvous); when
    None the launcher's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK) names the job. backend: NCCL on the card and gloo on the CPU
    (device="cpu") unless given; gloo may be asked for on the card (two
    processes that share one card, which NCCL refuses). NCCL is never
    replaced by gloo quietly: without it this raises.
    """
    if num_processes in (None, 1) and coordinator_address is None:
        return
    dev = resolve_device(device)
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this PyTorch build; run with --cpu "
                               "(gloo on the CPU) or ask for backend='gloo'")
        torch.cuda.set_device(local_rank(process_id))
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )


def shutdown() -> None:
    """Leave the job (every process, after its last collective)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(spp: int = 1, local_devices=None) -> Mesh:
    """('rays', 'spp') mesh of every process's cells.

    local_devices: this process's cells (default one, on cuda:LOCAL_RANK;
    repeat a device for several cells on it, ["cpu"] * 4). Cells are
    ordered by (rank, cell) and laid row-major, so each host's ranks (a
    launcher numbers them consecutively) stay together along 'spp' and the
    'rays' axis spans hosts.
    """
    local = [resolve_device(d) for d in local_devices] if local_devices is not None \
        else [torch.device("cuda", local_rank())]
    world = world_size()
    per_rank = [[str(d) for d in local]]
    if world > 1:
        per_rank = [None] * world
        dist.all_gather_object(per_rank, [str(d) for d in local])
    devs = [torch.device(d) for names in per_rank for d in names]
    ranks = [r for r, names in enumerate(per_rank) for _ in names]
    n = len(devs)
    if n % spp:
        raise ValueError(f"{n} cells do not split into an 'spp' axis of {spp}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(n // spp, spp), np.asarray(ranks).reshape(n // spp, spp))


def make_global_ray_batch(mesh: Mesh, width: int, height: int):
    """(raster_xy [N, 2], pixel_ids [N], npix): the whole batch, padded to the
    'rays' axis with the out-of-image id `npix` (shard.pad_ray_batch's
    sentinel), the same in every process; each renders its own shards."""
    return pad_ray_batch(width, height, mesh.shape["rays"])


def gather_film_to_host(film: torch.Tensor) -> Optional[np.ndarray]:
    """This process's film summed with every other process's: the numpy film
    on process 0, None elsewhere. Every process must call it (a collective).
    The processes hold disjoint 'rays' shards, so the sum adds zeros to each
    pixel's own value: the gathered film is bitwise one process's."""
    if world_size() > 1:
        film = film.clone()
        dist.all_reduce(film)
    return film.cpu().numpy() if process_rank() == 0 else None


def replicate(mesh: Mesh, obj):
    """Copy `obj` (a Medium, Camera or tensor) to the device of each of this
    process's cells now (shard.to_device), so that the first wave does not
    pay for it; returns `obj`, whose copies the sharded calls find."""
    for _, _, dev in mesh.local_cells():
        to_device(obj, dev)
    return obj
