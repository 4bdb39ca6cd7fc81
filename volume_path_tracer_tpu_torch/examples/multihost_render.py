"""Multi-process render and training launcher.

Port of examples/multihost_render.py on torch.distributed. Run the same
command in every process of the job:

    python -m volume_path_tracer_tpu_torch.examples.multihost_render \\
        --coordinator HOST0:PORT --num-processes N --process-id I [--train]

Alone it renders on one mesh of this process's cells (no process group).
Renders a 1024x1024 wdas_cloud-like scene sharded over every cell of the
job, reports rays/s, device-iterations and lane-iterations (the same on any
mesh: a work count with no clock in it), and with --train runs joint
density and temperature steps whose gradients are summed across processes.

Each process lays --local-cells cells (default 1) on its device:
cuda:LOCAL_RANK, or the CPU with --cpu. The backend is NCCL on the card and
gloo on the CPU; --backend gloo lets two processes share one card, which
NCCL refuses. --dump NPZ makes process 0 write the gathered film and, with
--train, the first step's summed gradients (the multi-process test and
chip_smoke.py compare them with a run of one process).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

if __package__ in (None, ""):  # run as a file: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np
import torch

from volume_path_tracer_tpu_torch.parallel import multihost


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", default=None, help="HOST:PORT of process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--waves", type=int, default=8)
    ap.add_argument("--spp-axis", type=int, default=1)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--train-size", type=int, default=32, help="training image edge (pixels)")
    ap.add_argument("--train-steps", type=int, default=10)
    ap.add_argument("--train-iters", type=int, default=512, help="step cap of a training path")
    ap.add_argument("--checkpoint", default=None, metavar="NPZ",
                    help="training checkpoint (grids + optimizer state)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="process group backend (default: nccl on the card, gloo on the CPU)")
    ap.add_argument("--local-cells", type=int, default=1, help="mesh cells this process lays on its device")
    ap.add_argument("--dump", default=None, metavar="NPZ",
                    help="process 0 writes the film and the first step's gradients here")
    return ap.parse_args(argv)


def main(argv=None):
    """Run one process of the job; returns process 0's summary (None elsewhere)."""
    args = parse_args(argv)
    multihost.initialize(args.coordinator, args.num_processes, args.process_id, backend=args.backend,
                         device="cpu" if args.cpu else None)
    try:
        return run(args)
    finally:
        multihost.shutdown()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _barrier():
    if multihost.world_size() > 1:
        torch.distributed.barrier()


def run(args):
    from volume_path_tracer_tpu_torch.grids.procedural import fog_sphere
    from volume_path_tracer_tpu_torch.models.camera import Camera
    from volume_path_tracer_tpu_torch.models.medium import Medium
    from volume_path_tracer_tpu_torch.parallel.shard import process_rank, render_wave_sharded
    from volume_path_tracer_tpu_torch.render.integrator import IntegratorParams
    from volume_path_tracer_tpu_torch.utils.config import CameraParameters

    dev = torch.device("cpu") if args.cpu else torch.device("cuda", multihost.local_rank())
    mesh = multihost.global_mesh(spp=args.spp_axis, local_devices=[dev] * args.local_cells)
    rank0 = process_rank() == 0
    if rank0:
        print(f"[multihost] {multihost.world_size()} processes, mesh {mesh.shape}", flush=True)

    W = H = args.size
    medium = multihost.replicate(mesh, Medium.from_grids(fog_sphere(radius=40.0, falloff=8.0), device=dev))
    camera = Camera.from_parameters(
        CameraParameters((150.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 35.0, 0.1), (W, H), device=dev,
    )
    params = IntegratorParams(
        sigma_a=0.0, sigma_s=0.15, hg_g=0.4, le_scale=0.0,
        temperature_offset=300.0, temperature_scale=40.0,
        infinite_xyz=(4.382, 3.509, 17.603), infinite_multiplier=0.14,
        distant_xyz=(0.95047, 1.0, 1.08883), distant_multiplier=50.0,
        distant_inv_direction=(0.5826, 0.766, 0.2717),
        max_depth=100, max_iters=4096,
    )
    raster, pids, npix = multihost.make_global_ray_batch(mesh, W, H)

    # warm-up: the kernels' constants and the shard plan
    render_wave_sharded(mesh, medium, params, camera, None, raster, pids, 10, 0, True, return_lane_iters=True)
    _sync(dev)
    _barrier()
    t0 = time.perf_counter()
    film = iters_tot = lane_tot = 0
    for w in range(1, args.waves + 1):
        contrib, _, iters, lane_iters = render_wave_sharded(
            mesh, medium, params, camera, None, raster, pids, 10, w, True, return_lane_iters=True,
        )
        film, iters_tot, lane_tot = film + contrib, iters_tot + iters, lane_tot + lane_iters
    _sync(dev)
    dt = time.perf_counter() - t0
    rays = npix * args.waves * mesh.shape["spp"]
    summary = None
    if rank0:
        # Two work measures: lane-iterations a wave is a pure count, the same
        # on any mesh (each lane's path is fixed by its counter-keyed draws),
        # which shows that no work is duplicated or skipped; rays/s and
        # iterations/s are clock rates, which processes sharing a card or a
        # host's cores hold back.
        n_cells = mesh.size
        it_tot, lane_it = int(iters_tot), int(lane_tot)
        summary = {"processes": multihost.world_size(), "mesh": mesh.shape, "rays": rays, "render_s": dt,
                   "rays_per_s": rays / dt, "device_iterations": it_tot,
                   "lane_iterations_per_wave": lane_it // args.waves, "device": str(dev)}
        print(f"[multihost] {rays / 1e6:.1f}M rays in {dt:.4f}s: {rays / dt / 1e6:.2f}M rays/s total, "
              f"{rays / dt / n_cells / 1e6:.3f}M rays/s/cell over {n_cells} cells, {it_tot} device-iterations, "
              f"{lane_it // args.waves} lane-iterations/wave (topology-invariant), "
              f"{it_tot / dt / n_cells:.1f} iters/s/device (contention-bound)", flush=True)
    # A collective: every process calls it.
    out = multihost.gather_film_to_host(film)
    dump = {}
    if rank0:
        out = out[:npix].reshape(H, W, 4)
        summary["film_mean_w"] = float(out[..., 3].mean())
        print(f"[multihost] film shape {out.shape}, mean w {out[..., 3].mean():.1f}", flush=True)
        dump["film"] = out
    if args.train:
        train_summary = train(args, mesh, dev, params, dump)
        if rank0:
            summary["train"] = train_summary
    if rank0 and args.dump:
        np.savez(args.dump, npix=npix, **dump)
    return summary


def train(args, mesh, dev, params, dump):
    """Joint density and temperature recovery toward a rendered target: the
    target is an emissive plume; training starts from a flattened density and
    a cooled temperature field. The optimizer state is checkpointed every
    step and training resumes from --checkpoint."""
    from volume_path_tracer_tpu_torch.diff.inverse import (
        OptimizableGrids, grid_leaves, load_train_checkpoint, make_optimizer, make_train_step,
        param_from_density, save_train_checkpoint,
    )
    from volume_path_tracer_tpu_torch.grids.procedural import fire_plume
    from volume_path_tracer_tpu_torch.models.camera import Camera
    from volume_path_tracer_tpu_torch.models.medium import Medium
    from volume_path_tracer_tpu_torch.parallel.shard import process_rank
    from volume_path_tracer_tpu_torch.render.renderer import pixel_coords, render_rays_wave
    from volume_path_tracer_tpu_torch.utils.config import CameraParameters
    from volume_path_tracer_tpu_torch.utils.spectral import blackbody_xyz_table

    rank0 = process_rank() == 0
    Wt = Ht = args.train_size
    dens_g, temp_raw = fire_plume(height=40, radius=10.0)
    # The plume's temperature normalised to a smooth [0, 10] field: with
    # offset 1100 K and scale 20 K the emission spans about 25x (not the
    # 10^4x of a raw fire core), which keeps the Monte Carlo loss floor well
    # below the optimization's signal at a few samples a step.
    temp_g = dataclasses.replace(temp_raw, data=temp_raw.data / float(temp_raw.data.max()) * 10.0)
    target_med = Medium.from_grids(dens_g, temp_g, pack=False, device=dev)
    tparams = dataclasses.replace(
        params, sigma_a=0.8, sigma_s=0.2, hg_g=0.6, le_scale=4e-7,
        temperature_offset=1100.0, temperature_scale=20.0,
        infinite_xyz=(1.0, 1.0, 1.0), infinite_multiplier=0.2,
        distant_xyz=(0.95047, 1.0, 1.08883), distant_multiplier=3.0, max_iters=1024,
    )
    tcam = Camera.from_parameters(
        CameraParameters((0.0, 20.0, -70.0), (0.0, 20.0, 0.0), (0.0, 1.0, 0.0), 40.0, 1.0), (Wt, Ht), device=dev,
    )
    bb = torch.from_numpy(blackbody_xyz_table()).to(dev)
    t_raster = torch.from_numpy(pixel_coords(Wt, Ht)).to(dev)
    t_pids = torch.arange(Wt * Ht, dtype=torch.int32, device=dev)

    # Target pixels: the mean over several waves of the target medium.
    n_tw = 6
    acc = 0
    for w in range(n_tw):
        contrib, _, _ = render_rays_wave(target_med, tparams, tcam, bb, t_raster, t_pids, 77, 100 + w, True, 1.0)
        acc = acc + contrib[:, :3]
    target_px = tcam.imaging_ratio * acc / n_tw

    start_dens = dens_g.data * 0.4 + 0.05
    start_temp = temp_g.data * 0.6
    base = Medium.from_grids(dataclasses.replace(dens_g, data=start_dens),
                             dataclasses.replace(temp_g, data=start_temp), pack=False, device=dev)
    grids = OptimizableGrids(
        log_density=param_from_density(start_dens.to(dev)).requires_grad_(True),
        temperature=start_temp.to(dev).clone().requires_grad_(True),
    )
    opt = make_optimizer(grids, lr=0.03)
    start_step = 0
    if args.checkpoint:
        ck = load_train_checkpoint(args.checkpoint, grids, opt)
        if ck is not None:
            grids, opt, start_step = ck
            if rank0:
                print(f"[multihost] resumed training at step {start_step}", flush=True)

    sharded = mesh.size > 1
    step = make_train_step(base, tparams, tcam, bb, n_iters=args.train_iters, mesh=mesh if sharded else None,
                           samples_per_step=8, use_prb=True)
    pad = (-t_pids.shape[0]) % mesh.shape["rays"] if sharded else 0
    if pad:
        # Training pads with pixel 0 (raster, id and target): each padded row
        # adds a valid loss term for pixel 0 (weighting it a little more)
        # where a zero target would add a meaningless residual. (The film
        # pads with the out-of-image id `npix` instead: its padding rows are
        # sliced off, not summed into a loss.)
        t_raster = torch.cat([t_raster, t_raster[:1].expand(pad, 2)])
        t_pids = torch.cat([t_pids, torch.zeros((pad,), dtype=torch.int32, device=dev)])
        target_px = torch.cat([target_px, target_px[:1].expand(pad, 3)])

    _sync(dev)
    t0 = time.perf_counter()
    losses = []
    for it in range(start_step, start_step + args.train_steps):
        grids, opt, loss = step(grids, opt, t_raster, t_pids, target_px, (77, it + 1))
        losses.append(float(loss))
        if it == start_step:
            for name, p in zip(("grad_density", "grad_temperature"), grid_leaves(grids)):
                if p.grad is not None:  # a step replayed as a CUDA graph keeps no .grad
                    dump[name] = p.grad.detach().cpu().numpy()
            dump["loss0"] = np.float32(losses[0])
        if rank0:
            print(f"[train] step {it}: loss {losses[-1]:.6f}", flush=True)
            if args.checkpoint:
                save_train_checkpoint(args.checkpoint, grids, opt, it + 1)
    _sync(dev)
    dt = time.perf_counter() - t0
    if rank0:
        print(f"[multihost] {len(losses)} joint density+temperature steps in {dt:.2f}s; loss "
              f"{losses[0]:.5f} -> {losses[-1]:.5f}", flush=True)
    return {"steps": len(losses), "train_s": dt, "loss_first": losses[0], "loss_last": losses[-1]}


if __name__ == "__main__":
    main()
