"""Inverse rendering example: recover grids from rendered targets.

Port of examples/inverse_rendering.py. Renders target images of a blob from
three viewpoints, then optimizes a flat initial density to match through
the path-replay train step (diff/inverse.py make_train_step), reporting the
loss and the voxel correlation and writing the targets and the recovered
renders as PNGs:

    python -m volume_path_tracer_tpu_torch.examples.inverse_rendering [--cpu] [--steps 60] [--out DIR]

`--joint` recovers density and temperature together on an emissive blob
(blackbody emission through the spectral table): the optimization starts
from the true density (free to drift) and a flat background temperature,
and writes the loss and temperature-error curve to <out>/joint_recovery.json:

    python -m volume_path_tracer_tpu_torch.examples.inverse_rendering --joint [--steps 60]

Runs on the CUDA device unless --cpu is given, and writes only under --out.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):  # run as a file: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np
import torch

from volume_path_tracer_tpu_torch.diff.inverse import (
    OptimizableGrids, density_from_param, make_optimizer, make_train_step, param_from_density,
)
from volume_path_tracer_tpu_torch.grids.grid import dense_grid_from_array
from volume_path_tracer_tpu_torch.io.png import write_png
from volume_path_tracer_tpu_torch.models.camera import Camera
from volume_path_tracer_tpu_torch.models.medium import Medium
from volume_path_tracer_tpu_torch.render.integrator import IntegratorParams
from volume_path_tracer_tpu_torch.render.renderer import pixel_coords, render_rays_wave
from volume_path_tracer_tpu_torch.utils.color import film_to_srgb_u8
from volume_path_tracer_tpu_torch.utils.config import CameraParameters
from volume_path_tracer_tpu_torch.utils.device import resolve_device
from volume_path_tracer_tpu_torch.utils.spectral import blackbody_xyz_table


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=24, help="image width/height")
    ap.add_argument("--grid", type=int, default=12, help="density grid size")
    ap.add_argument("--joint", action="store_true",
                    help="joint density+temperature recovery (emissive scene)")
    ap.add_argument("--out", default="/tmp/vpt_inverse_torch")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the example; returns its summary (also printed)."""
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    dev = resolve_device("cpu" if args.cpu else None)
    return (joint_main if args.joint else density_main)(args, dev)


def _batch(W, H, dev):
    raster = torch.from_numpy(pixel_coords(W, H)).to(dev)
    return raster, torch.arange(W * H, dtype=torch.int32, device=dev)


def render_mean(medium, params, cam, bb, raster, pids, seed, waves):
    """Per-pixel mean XYZ [N, 3] of `waves` waves (500, 501, ... of `seed`)."""
    acc = 0
    for w in range(waves):
        contrib, _, _ = render_rays_wave(medium, params, cam, bb, raster, pids, seed, 500 + w, True, 1.0)
        acc = acc + contrib[:, :3]
    return acc / waves


def write_film(path, px, W, H):
    film = torch.cat([px, torch.ones((px.shape[0], 1), dtype=px.dtype, device=px.device)], -1).reshape(H, W, 4)
    write_png(path, film_to_srgb_u8(film).cpu().numpy())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def density_main(args, dev) -> dict:
    n = args.grid
    i = np.arange(n) - (n - 1) / 2
    x, y, z = np.meshgrid(i, i, i, indexing="ij")
    target_rho = (np.exp(-(x**2 + 1.5 * y**2 + z**2) / (n / 1.6)) * 0.9).astype(np.float32)
    med_target = Medium.from_grids(dense_grid_from_array(target_rho), pack=False, device=dev)

    W = H = args.size
    dist = n * 2.6
    params = IntegratorParams(
        sigma_a=0.3, sigma_s=0.0, hg_g=0.0, le_scale=0.0,
        temperature_offset=300.0, temperature_scale=40.0,
        infinite_xyz=(1.0, 1.0, 1.0), infinite_multiplier=1.0,
        distant_xyz=(0.0, 0.0, 0.0), distant_multiplier=0.0,
        distant_inv_direction=(0.0, 1.0, 0.0), max_depth=50, max_iters=256,
    )
    views = [(dist, 0.0, 0.0), (0.0, 0.0, dist), (0.0, dist * 1.0, 0.1)]
    cams = [
        Camera.from_parameters(
            CameraParameters(p, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0) if abs(p[1]) < 1 else (1.0, 0.0, 0.0),
                             40.0, 1.0),
            (W, H), device=dev,
        )
        for p in views
    ]
    raster, pids = _batch(W, H, dev)

    print("[inverse] rendering targets...")
    targets = [render_mean(med_target, params, c, None, raster, pids, 11, 24) for c in cams]
    for vi, t in enumerate(targets):
        write_film(f"{args.out}/target_v{vi}.png", t, W, H)

    start = np.full((n, n, n), 0.25, np.float32)
    base_med = Medium.from_grids(dense_grid_from_array(start), pack=False, device=dev)
    grids = OptimizableGrids(param_from_density(torch.from_numpy(start).to(dev)).requires_grad_(True))
    opt = make_optimizer(grids, lr=0.08)
    steps = [make_train_step(base_med, params, c, None, n_iters=192, samples_per_step=8) for c in cams]

    def vox_corr():
        rec = density_from_param(grids.log_density.detach()).cpu().numpy()
        return rec, float(np.corrcoef(rec.reshape(-1), target_rho.reshape(-1))[0, 1])

    _sync(dev)
    t0 = time.perf_counter()
    first_loss = loss = None
    for it in range(args.steps):
        for vi, (stepf, tgt) in enumerate(zip(steps, targets)):
            grids, opt, loss = stepf(grids, opt, raster, pids, tgt, (11, it * len(cams) + vi + 1))
        if first_loss is None:
            first_loss = float(loss)
        if (it + 1) % 10 == 0 or it == 0:
            print(f"[inverse] step {it + 1:3d} loss={float(loss):.5f} vox_corr={vox_corr()[1]:.3f}")
    _sync(dev)
    train_s = time.perf_counter() - t0

    rec, corr = vox_corr()
    med_rec = Medium.from_grids(dense_grid_from_array(rec), pack=False, device=dev)
    for vi, cam in enumerate(cams):
        write_film(f"{args.out}/recovered_v{vi}.png", render_mean(med_rec, params, cam, None, raster, pids, 77, 24),
                   W, H)
    summary = {
        "mode": "density", "device": str(dev), "grid": n, "image": [W, H], "steps": args.steps,
        "train_steps": args.steps * len(cams), "train_s": train_s,
        "steps_per_s": args.steps * len(cams) / train_s if train_s else None,
        "loss_first": first_loss, "loss_last": float(loss), "vox_corr": corr,
    }
    print(f"[inverse] done: {summary['train_steps']} train steps in {train_s:.2f} s, loss {first_loss:.5f} -> "
          f"{float(loss):.5f}, voxel corr {corr:.3f}; images in {args.out}/")
    return summary


def joint_main(args, dev) -> dict:
    """Joint density and temperature recovery on an emissive blob.

    The target emits blackbody radiation; the optimization starts from the
    true density and a flat background temperature and must reconstruct the
    hot core from pixel gradients alone, through the spectral table's slope.
    """
    n = args.grid
    i = np.arange(n) - (n - 1) / 2
    x, y, z = np.meshgrid(i, i, i, indexing="ij")
    r2 = x**2 + y**2 + z**2
    rho_true = (np.exp(-r2 / (n / 1.2)) * 0.8).astype(np.float32)
    # A hot core on a warm background, narrow contrast (T 1.1-1.3 kK):
    # blackbody radiance is exponential in T, and a wide contrast makes the
    # per-sample radiance span decades, so the Monte Carlo noise swamps the
    # optimization's signal at batches of this size.
    temp_true = (20.0 + 5.0 * np.exp(-r2 / (n / 1.6))).astype(np.float32)
    med_true = Medium.from_grids(dense_grid_from_array(rho_true), dense_grid_from_array(temp_true), pack=False,
                                 device=dev)
    bb = torch.from_numpy(blackbody_xyz_table()).to(dev)
    params = IntegratorParams(
        sigma_a=0.4, sigma_s=0.0, hg_g=0.0, le_scale=5e-4,
        temperature_offset=300.0, temperature_scale=40.0,
        infinite_xyz=(1.0, 1.0, 1.0), infinite_multiplier=0.2,
        distant_xyz=(0.0, 0.0, 0.0), distant_multiplier=0.0,
        distant_inv_direction=(0.0, 1.0, 0.0), max_depth=50, max_iters=256,
    )
    W = H = args.size
    camera = Camera.from_parameters(
        CameraParameters((n * 2.6, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 42.0, 1.0), (W, H), device=dev,
    )
    raster, pids = _batch(W, H, dev)

    print("[joint] rendering emissive targets...")
    target_px = render_mean(med_true, params, camera, bb, raster, pids, 11, 16)
    write_film(f"{args.out}/joint_target.png", target_px, W, H)

    temp0 = np.full((n, n, n), 20.0, np.float32)
    base_med = Medium.from_grids(dense_grid_from_array(rho_true), dense_grid_from_array(temp0), pack=False,
                                 device=dev)
    grids = OptimizableGrids(
        log_density=param_from_density(torch.from_numpy(rho_true).to(dev)).requires_grad_(True),
        temperature=torch.from_numpy(temp0).to(dev).requires_grad_(True),
    )
    # Per-parameter learning rates (the density starts at the truth, the
    # temperature must travel) and the dual-buffer loss (an unbiased MSE
    # gradient: the plain k-sample MSE's variance term biases emission).
    opt = torch.optim.Adam([{"params": [grids.log_density], "lr": 0.02},
                            {"params": [grids.temperature], "lr": 0.3}], betas=(0.9, 0.999), eps=1e-8,
                           capturable=grids.log_density.is_cuda)  # on the card the step replays a CUDA graph
    step = make_train_step(base_med, params, camera, bb, n_iters=256, samples_per_step=4, dual_buffer=True)

    # Error metrics weight by density: emission is p_a * bb(T) with p_a ~
    # rho, so zero-density voxels emit nothing and no image constrains
    # their temperature.
    wgt = rho_true / rho_true.sum()

    def werr(t):
        return float((wgt * np.abs(t - temp_true)).sum())

    err0 = werr(temp0)
    curve = []
    _sync(dev)
    t0 = time.perf_counter()
    for it in range(args.steps):
        grids, opt, loss = step(grids, opt, raster, pids, target_px, (11, it + 1))
        rec = grids.temperature.detach().cpu().numpy()
        err = werr(rec)
        corr = float(np.corrcoef(rec.reshape(-1), temp_true.reshape(-1))[0, 1])
        curve.append({"step": it + 1, "loss": float(loss), "temp_mae": round(err, 4), "temp_corr": round(corr, 4)})
        if (it + 1) % 10 == 0 or it == 0:
            print(f"[joint] step {it + 1:3d} loss={float(loss):.5f} T_mae={err:.3f} (init {err0:.3f}) "
                  f"T_corr={corr:.3f}")
    _sync(dev)
    train_s = time.perf_counter() - t0

    med_rec = Medium.from_grids(
        dense_grid_from_array(density_from_param(grids.log_density.detach())),
        dense_grid_from_array(grids.temperature.detach()), pack=False, device=dev,
    )
    write_film(f"{args.out}/joint_recovered.png", render_mean(med_rec, params, camera, bb, raster, pids, 77, 16),
               W, H)
    summary = {
        "scene": "emissive plume, joint density+temperature", "device": str(dev),
        "grid": n, "image": [W, H], "steps": args.steps,
        "temp_mae_init": round(err0, 4),
        "temp_mae_final": curve[-1]["temp_mae"],
        "temp_corr_final": curve[-1]["temp_corr"],
        "loss_first": curve[0]["loss"], "loss_last": curve[-1]["loss"],
        "train_s": train_s, "steps_per_s": args.steps / train_s if train_s else None,
        "curve": curve,
    }
    with open(f"{args.out}/joint_recovery.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[joint] done: {args.steps} train steps in {train_s:.2f} s, T_mae {err0:.3f} -> "
          f"{summary['temp_mae_final']:.3f}, T_corr {summary['temp_corr_final']:.3f}; artifacts in {args.out}/")
    return summary


if __name__ == "__main__":
    main()
