"""Command-line renderer: the port of volume_path_tracer_tpu/cli.py.

Usage:

    python -m volume_path_tracer_tpu_torch.cli <scene.json> <out.png> [options]

Renders on the CUDA device (--cpu for the CPU), wave by wave, with a
progress line (percent, ETA, rays/s), an optional preview PNG at wave
boundaries or a live ANSI preview in the terminal (--live), wave-boundary
checkpoints (resumed when present), a graceful first ^C that finishes the
wave and saves, and an optional torch.profiler trace of the set-up and the
wave loop, with the port's spans (--profile DIR). With more than one CUDA
device, or --mesh N, each wave is sharded over a mesh of devices
(parallel/shard.py render_wave_sharded); the film is bitwise the one-device
film. --cpu --mesh N lays N cells on the CPU.

Volume loading: reads the scene's .nvdb through the package's own NanoVDB
parser (grids/nvdb.py). `--procedural {donut,sphere,plume}` substitutes an
asset-free volume (the reference renderer's generate_donut debug path).
The medium takes the fused table where it fits on the device and is read
from the grids' own dense arrays where not (models.medium.choose_pack); the
set-up prints the form and the bytes the medium holds there.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .utils import logging as vlog


def _load_medium(cfg, procedural, device):
    """The scene's medium on `device`: the grids' fused table where it fits
    beside the grids and one wave of the scene's frame, else their own dense
    arrays (choose_pack)."""
    from .grids import procedural as proc
    from .models.medium import Medium, choose_pack

    temperature = None
    if procedural == "donut":
        density = proc.generate_donut()
    elif procedural == "sphere":
        density = proc.fog_sphere(radius=24.0, falloff=4.0)
    elif procedural == "plume":
        density, temperature = proc.fire_plume()
    elif procedural:
        vlog.fatal(f"unknown procedural volume {procedural!r}")
    else:
        if not os.path.exists(cfg.volume_path):
            # The reference fatals on a missing or unreadable volume file
            # (volume_grids.cpp:52 via vptFATAL).
            vlog.fatal(
                f"volume file {cfg.volume_path!r} not found "
                f"(use --procedural for an asset-free volume)"
            )
        from .grids.nvdb import read_nvdb_grids

        density, temperature = read_nvdb_grids(cfg.volume_path)
    width, height = cfg.output_size
    pack = choose_pack(density, temperature, device=device, pixels=width * height)
    return Medium.from_grids(density, temperature, pack=pack, device=device)


def downsample_srgb_u8(img_u8: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[H, W, 3] uint8 -> [out_h, out_w, 3] uint8 on the image's device: the
    live preview's downsample, so that only the painted cells cross to the
    host. Bilinear with antialiasing (a triangle filter widened by the
    shrink factor), as jax.image.resize(..., "linear") does in the JAX CLI;
    the float result is truncated, so a last-bit difference at an integer
    boundary could show as one u8 level (tests/test_torch_cli_tools.py holds
    the two to that, and finds no differing pixel)."""
    x = img_u8.to(torch.float32).permute(2, 0, 1)[None]
    small = torch.nn.functional.interpolate(
        x, size=(out_h, out_w), mode="bilinear", antialias=True, align_corners=False
    )
    return small[0].permute(1, 2, 0).clamp(0, 255).to(torch.uint8)


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
    ap.add_argument("--live", action="store_true",
                    help="paint a live ANSI preview of the film in the "
                         "terminal at each wave boundary (the raylib-window "
                         "equivalent for headless hosts)")
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
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="shard rays over N devices (default: every CUDA "
                         "device when there are several; with --cpu, N "
                         "cells on the CPU)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the set-up and the render "
                         "(with the port's spans) to DIR")
    args = ap.parse_args(argv)
    if args.mesh is not None and args.mesh < 1:
        vlog.fatal(f"--mesh {args.mesh}: the device count must be at least 1")

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
    mesh = _mesh(args.mesh, device)
    # The trace covers the set-up too (the port's spans medium.build,
    # kernel.build, shard.copy), then the waves.
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(args.profile, exist_ok=True)
        prof = profile(activities=activities)
        prof.start()

    medium = _load_medium(cfg, args.procedural, device)
    vlog.info(f"medium: {medium.form}, {medium.resident_bytes / 1e9:.3f} GB resident on {device}")
    scene = Scene.from_config(cfg, medium, max_iters=args.max_iters, device=device)
    num_waves = args.waves if args.waves is not None else cfg.num_waves
    batch = None
    if mesh is not None:
        from .parallel.shard import pad_ray_batch

        batch = pad_ray_batch(scene.width, scene.height, mesh.shape["rays"])
        vlog.info(f"sharding rays over {mesh.shape} cells")
        if args.chunk_pixels:
            vlog.warn("--chunk-pixels is ignored on a mesh: each cell renders its whole shard")

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
    last_paint = 0.0
    last_ckpt = time.monotonic()
    # Truncated-lane counts accumulate on the device across waves and are
    # read once at the end: a read per wave would wait for the device.
    ncap_total = torch.zeros((), dtype=torch.int64, device=device)

    def to_image(f):
        return film_to_srgb_u8(f).cpu().numpy()

    live = None
    if args.live:
        from .io.term import TermPreview

        live = TermPreview()
        if not live.enabled:
            vlog.warn("--live requires a TTY; disabled")
            live = None

    def write_preview(img):
        nonlocal last_preview
        if args.preview and time.monotonic() - last_preview >= preview_every_s:
            write_png(args.preview, img, atomic=True)
            last_preview = time.monotonic()

    def live_draw(film_now, status):
        # Tonemap and downsample to the terminal's cell grid on the device,
        # then bring only the painted cells to the host.
        out_h, out_w = live.geometry(scene.height, scene.width)
        live.draw(downsample_srgb_u8(film_to_srgb_u8(film_now), out_h, out_w).cpu().numpy(), status)

    # Mid-wave feedback (the reference GUI repaints at 5 FPS during a wave,
    # main.cpp:101-132): when --chunk-pixels splits a wave, repaint the live
    # preview or the progress line at chunk boundaries with the partial film.
    # Throttle time stamps are taken AFTER the work: tonemap and PNG encode
    # of a large film can exceed the interval itself, and a stamp taken
    # before the work then degenerates to encoding at every chunk. Preview
    # PNG writes get a longer interval than the cheap terminal repaint for
    # the same reason.
    chunk_cb = None
    if args.chunk_pixels and (live is not None or args.preview):

        def chunk_cb(done, total, film_now):
            nonlocal last_paint
            now = time.monotonic()
            if now - last_paint < 0.2:  # 5 FPS cap, like the reference
                return
            status = f"[vpt] {tracker.format()} (wave {done * 100 // total}%)"
            # Tonemap the whole film only when something consumes the pixels.
            if args.preview and now - last_preview >= preview_every_s:
                img = to_image(film_now)
                if live is not None:
                    live.draw(img, status)
                else:
                    print(f"\r{status}   ", end="", flush=True)
                write_preview(img)
            elif live is not None:
                live_draw(film_now, status)
            else:
                print(f"\r{status}   ", end="", flush=True)
            last_paint = time.monotonic()

    with StopController() as stop:
        w = start_wave
        while w < num_waves:
            w += 1
            t_wave = time.perf_counter()
            if mesh is not None:
                film, ncap_w = _render_wave_sharded(scene, mesh, batch, w, film)
            else:
                film, ncap_w = render_wave_image(
                    scene, w, film, args.chunk_pixels, chunk_callback=chunk_cb, return_ncap=True
                )
            ncap_total = ncap_total + ncap_w
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt_wave = time.perf_counter() - t_wave
            tracker.advance(1)
            # Per-wave throughput: one wave = one camera ray per pixel.
            status = f"[vpt] {tracker.format()} ({npix / dt_wave / 1e6:.2f} M rays/s)"
            stopping = stop.stop_at_next_wave or w == num_waves
            if live is not None:
                live_draw(film, status)
            else:
                print(f"\r{status}   ", end="", flush=True)
            # The tonemap is gated on the preview throttle too, not only the
            # PNG write: it brings the whole film to the host.
            if args.preview and not stopping and time.monotonic() - last_preview >= preview_every_s:
                write_preview(to_image(film))
            if args.checkpoint and (
                stopping or time.monotonic() - last_ckpt >= args.checkpoint_every_s
            ):
                save_checkpoint(args.checkpoint, film.cpu().numpy(), w, scene.seed)
                last_ckpt = time.monotonic()
            if stop.stop_at_next_wave:
                print(flush=True)
                vlog.info(f"stopped at wave boundary {w}")
                break

    if prof is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        trace_path = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace_path)
        print(flush=True)
        vlog.info(f"profiler trace written to {trace_path}")

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


def _mesh(n, device):
    """The mesh of --mesh n (None: one device). By default every CUDA device
    when there are several; more than the visible devices is fatal; on the
    CPU, n cells there."""
    from .parallel.shard import make_mesh

    if device.type == "cpu":
        return make_mesh(n, devices=[device] * n) if n and n > 1 else None
    n_dev = torch.cuda.device_count()
    if n is not None and n > n_dev:
        vlog.fatal(f"--mesh {n} exceeds the {n_dev} visible CUDA device(s) (--cpu --mesh {n} lays "
                   f"{n} cells on the CPU)")
    n = n or n_dev
    return make_mesh(n) if n > 1 else None


def _render_wave_sharded(scene, mesh, batch, wave, film):
    """One wave over the mesh added to the film: (film, n_capped). batch:
    pad_ray_batch's arrays, the same every wave (their shard plan is made
    once)."""
    from .parallel.shard import render_wave_sharded

    H, W = scene.height, scene.width
    coords, pids, npix = batch
    contrib, n_capped, _ = render_wave_sharded(
        mesh, scene.medium, scene.params, scene.camera, scene.bb_table,
        coords, pids, scene.seed, wave, scene.use_jitter,
    )
    return film + contrib[:npix].reshape(H, W, 4), n_capped


if __name__ == "__main__":
    sys.exit(main())
