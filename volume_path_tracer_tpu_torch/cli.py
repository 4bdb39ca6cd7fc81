"""Command-line renderer: the port of volume_path_tracer_tpu/cli.py.

Usage:

    python -m volume_path_tracer_tpu_torch.cli <scene.json> <out.png> [options]

Renders on the CUDA device (--cpu for the CPU), wave by wave, with a
progress line (percent, ETA, rays/s), an optional preview PNG at wave
boundaries, wave-boundary checkpoints (resumed when present), and a graceful
first ^C that finishes the wave and saves. Volumes: `--procedural
{donut,sphere,plume}`; reading the scene's .nvdb file is not ported yet.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .utils import logging as vlog


def _load_medium(cfg, procedural, device):
    from .grids import procedural as proc
    from .models.medium import Medium

    if procedural == "donut":
        return Medium.from_grids(proc.generate_donut(), device=device)
    if procedural == "sphere":
        return Medium.from_grids(proc.fog_sphere(radius=24.0, falloff=4.0), device=device)
    if procedural == "plume":
        d, t = proc.fire_plume()
        return Medium.from_grids(d, t, device=device)
    vlog.fatal(
        f"reading .nvdb volumes ({cfg.volume_path!r}) is not ported yet; "
        f"use --procedural {{donut,sphere,plume}}"
    )


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="vpt-torch", description="volumetric path tracer (PyTorch/CUDA port)"
    )
    ap.add_argument("config", help="scene JSON (reference schema)")
    ap.add_argument("output", help="output PNG path")
    ap.add_argument("--waves", type=int, default=None, help="override num_waves")
    ap.add_argument(
        "--procedural", choices=["donut", "sphere", "plume"], default=None,
        help="use a procedural volume instead of the scene's .nvdb",
    )
    ap.add_argument("--preview", default=None, metavar="PNG",
                    help="write a preview PNG at wave boundaries")
    ap.add_argument("--checkpoint", default=None, metavar="NPZ",
                    help="wave-boundary checkpoint file (resumes if present)")
    ap.add_argument("--checkpoint-every-s", type=float, default=60.0,
                    help="minimum seconds between checkpoint writes "
                         "(always written when stopping)")
    ap.add_argument("--chunk-pixels", type=int, default=None,
                    help="render each wave in pixel chunks of this size")
    ap.add_argument("--max-iters", type=int, default=8192,
                    help="tracing step cap per ray")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)

    from .io.png import write_png
    from .render.renderer import Scene, render_wave_image
    from .render.waves import ProgressTracker, StopController, load_checkpoint, save_checkpoint
    from .utils.color import film_to_srgb_u8
    from .utils.config import ConfigError, read_configuration
    from .utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    try:
        cfg = read_configuration(args.config)
    except ConfigError as e:
        vlog.fatal(str(e))
    medium = _load_medium(cfg, args.procedural, device)
    scene = Scene.from_config(cfg, medium, max_iters=args.max_iters, device=device)
    num_waves = args.waves if args.waves is not None else cfg.num_waves

    start_wave = 0
    film = torch.zeros((scene.height, scene.width, 4), dtype=torch.float32, device=device)
    if args.checkpoint:
        ck = load_checkpoint(args.checkpoint)
        if ck is not None:
            f0, w0, s0 = ck
            if s0 == scene.seed and tuple(f0.shape) == tuple(film.shape):
                film, start_wave = torch.from_numpy(np.asarray(f0, np.float32)).to(device), w0
                vlog.info(f"resumed from wave {w0}")
            else:
                vlog.warn("checkpoint mismatch - starting fresh")

    tracker = ProgressTracker(num_waves)
    tracker.advance(start_wave)
    npix = scene.width * scene.height
    preview_every_s = 2.0
    last_preview = 0.0
    last_ckpt = time.monotonic()
    ncap_total = torch.zeros((), dtype=torch.int64, device=device)

    def to_image(f):
        return film_to_srgb_u8(f).cpu().numpy()

    with StopController() as stop:
        w = start_wave
        while w < num_waves:
            w += 1
            t_wave = time.perf_counter()
            film, ncap_w = render_wave_image(
                scene, w, film, args.chunk_pixels, return_ncap=True
            )
            ncap_total = ncap_total + ncap_w
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt_wave = time.perf_counter() - t_wave
            tracker.advance(1)
            print(f"\r[vpt] {tracker.format()} ({npix / dt_wave / 1e6:.2f} M rays/s)   ",
                  end="", flush=True)
            stopping = stop.stop_at_next_wave or w == num_waves
            if args.preview and not stopping and time.monotonic() - last_preview >= preview_every_s:
                write_png(args.preview, to_image(film), atomic=True)
                last_preview = time.monotonic()
            if args.checkpoint and (
                stopping or time.monotonic() - last_ckpt >= args.checkpoint_every_s
            ):
                save_checkpoint(args.checkpoint, film.cpu().numpy(), w, scene.seed)
                last_ckpt = time.monotonic()
            if stop.stop_at_next_wave:
                print(flush=True)
                vlog.info(f"stopped at wave boundary {w}")
                break

    ncap = int(ncap_total)
    if ncap:
        print(flush=True)
        vlog.warn(
            f"{ncap} rays (all waves) truncated at the iteration cap "
            f"(max_iters={scene.params.max_iters}) - raise --max-iters "
            f"to eliminate the bias"
        )
    write_png(args.output, to_image(film))
    print(flush=True)
    vlog.info(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
