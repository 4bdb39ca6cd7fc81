"""Benchmark of the port: camera-ray throughput on the flagship wdas_cloud-like
configuration, on the CUDA device.

    python -m volume_path_tracer_tpu_torch.bench [--full | --verify | --render1024] [--out DIR] [--cpu]

The counterpart of the repository's root bench.py (the JAX package's
benchmark): the same modes, scenes, sizes, timing method and JSON keys, run
through the port's entry points. Prints ONE JSON line: {"metric", "value",
"unit", "method", "pass_times_s", "device", "build_s"}.

Metric: rays/s on one GPU on the wdas_cloud configuration at 256x256 @ 16
spp. "Rays" counts camera rays (pixel samples); each ray's full transport
(multiple scattering, NEE shadow rays) is included in the cost.

Scene (bench.py's): the reference's wdas_cloud.json transport parameters
(sigma_s=0.15, g=0.4, distant + infinite lights, max_depth=100) on a
procedural 77^3 fog sphere (fog_sphere(radius=30, falloff=6)) standing in for
the absent wdas_cloud.nvdb asset.

Timing: each wave is one launch of megakernel.render_wave (render_wave_kernel
on the card) over every pixel into one film on the device. The kernel
library is built (nvcc, at first use) and loaded before anything is timed,
and its seconds are reported as build_s. Then one warm-up pass and `reps`
timed passes of all waves; every timed pass ends in a forced device-to-host
read of the film's checksum, which is what waits for the device. The best
pass is the number; every pass is recorded.

--full (-> OUT/bench_extra.json): the 512^3 cloud packed and unpacked, the
fire max_iters sweep, the aligned and the low-scattering fire, the density
and the joint train steps, each cell's peak device memory.
--verify (-> OUT/bench_verify.json): each scene rendered by the plain
version (megakernel.render_wave_plain, on the device) and by the kernel
(render_wave): lane agreement, mean agreement and the per-sample range of
the disagreeing lanes, with bench.py's gates.
--render1024 (merged into OUT/bench_extra.json): a 1024x1024 x 64-wave
render through cli.main in-process, cold and warm, with peak device memory.

OUT is --out (default bench_torch_out/); nothing is written elsewhere. The
bench runs on the CUDA device and raises without one; --cpu runs it on the
CPU (the plain versions: a check of the bench's own code, not a device
number). A failed gate or a non-finite checksum exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .diff import inverse as inv
from .grids.grid import dense_grid_from_array
from .grids.procedural import big_cloud, fire_plume, fog_sphere
from .models.camera import Camera
from .models.medium import Medium
from .render import megakernel as mk
from .render.integrator import _SUPER_TAU, IntegratorParams
from .render.renderer import pixel_coords
from .utils import rng as vrng
from .utils.config import CameraParameters
from .utils.device import resolve_device
from .utils.spectral import blackbody_xyz_table

METRIC = "wdas_cloud-like 256x256@16spp camera-ray throughput"
UNIT = "rays/s/GPU"
DEFAULT_OUT = "bench_torch_out"
SEED = 10


class GateFailed(RuntimeError):
    """A correctness gate of the bench failed."""


def _gate(cond, msg):
    if not cond:
        raise GateFailed(msg)


def _wdas_params(max_iters=4096):
    # scenes/wdas_cloud.json transport parameters. VPT_BENCH_SUPER_TAU lets
    # one command A/B the superbrick-opportunism threshold without editing
    # the pinned scene.
    tau = float(os.environ.get("VPT_BENCH_SUPER_TAU", _SUPER_TAU))
    return IntegratorParams(
        sigma_a=0.0, sigma_s=0.15, hg_g=0.4, le_scale=0.0,
        temperature_offset=300.0, temperature_scale=40.0,
        infinite_xyz=(4.382, 3.509, 17.603), infinite_multiplier=0.14,
        distant_xyz=(0.95047, 1.0, 1.08883), distant_multiplier=50.0,
        distant_inv_direction=(0.5826, 0.7660, 0.2717),
        max_depth=100, max_iters=max_iters, super_tau=tau,
    )


def _fire_params(max_iters=8192):
    # scenes/fire.json transport parameters (max_depth 10^6, sigma_t=2.9)
    return IntegratorParams(
        sigma_a=2.0, sigma_s=0.9, hg_g=0.7, le_scale=4e-8,
        temperature_offset=300.0, temperature_scale=43.0,
        infinite_xyz=(0.25, 0.25, 0.5), infinite_multiplier=10.0,
        distant_xyz=(0.95047, 1.0, 1.08883), distant_multiplier=20.0,
        distant_inv_direction=(0.5, 1.0, 0.0),
        max_depth=1_000_000, max_iters=max_iters,
    )


def _camera(W, H, pos, look=(0.0, 0.0, 0.0), vfov=35.0, ratio=0.1, device=None):
    return Camera.from_parameters(
        CameraParameters(tuple(pos), tuple(look), (0.0, 1.0, 0.0), vfov, ratio), (W, H), device=device
    )


def _flagship(dev, size=256):
    """(medium, camera) of the flagship cell: fog_sphere(30, 6), camera (110, 0, 0)."""
    return (Medium.from_grids(fog_sphere(radius=30.0, falloff=6.0), device=dev),
            _camera(size, size, (110.0, 0.0, 0.0), device=dev))


def _fire_camera(size, dev):
    return _camera(size, size, (170.0, 48.0, 0.0), look=(0.0, 48.0, 0.0), vfov=37.0, device=dev)


def _aligned(temp):
    """The temperature grid with the density grid's transform (no half-voxel
    shift): its corners fold into 16-wide fused rows."""
    return dense_grid_from_array(temp.data, temp.origin_ijk, temp.voxel_size, (0.0, 0.0, 0.0))


def _blackbody(dev):
    return torch.from_numpy(blackbody_xyz_table()).to(dev)


def card(dev) -> dict:
    """The card's name and power limit as nvidia-smi gives them ({"name":
    "cpu", "power_limit": null} on the CPU)."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    name, limit = r.stdout.strip().splitlines()[0].rsplit(", ", 1)
    return {"name": name, "power_limit": limit}


def build_kernels(dev) -> Optional[float]:
    """Build (nvcc, at first use in this checkout) and load the kernel
    library: its seconds, None on the CPU (no kernel runs there)."""
    if dev.type != "cuda":
        return None
    t0 = time.perf_counter()
    mk._library()
    return round(time.perf_counter() - t0, 2)


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev, unit) -> Optional[float]:
    """Peak device memory since the last reset, in bytes / unit (None on the CPU)."""
    return round(torch.cuda.max_memory_allocated(dev) / unit, 3) if dev.type == "cuda" else None


def _free(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wave(wave_fn, medium, camera, params, bb, film, seed, w):
    """Wave `w` of every pixel added to `film` by ONE call of wave_fn (a
    pixel id may occur once a launch): (iterations, n_capped)."""
    n = film.shape[0] * film.shape[1]
    return wave_fn(medium, params, camera, bb, film, range(0, n), vrng.mix_stream(seed, w), True,
                   camera.imaging_ratio)


def wave_radiance(wave_fn, medium, camera, params, W, H, bb=None, seed=SEED, w=1):
    """One wave on a zero film: (each lane's imaging_ratio * L as numpy [W*H,
    3], n_capped), what bench.py's wave function returns per lane."""
    film = torch.zeros((H, W, 4), dtype=torch.float32, device=medium.device)
    _, ncap = _wave(wave_fn, medium, camera, params, bb, film, seed, w)
    return film[..., :3].reshape(-1, 3).cpu().numpy(), int(ncap)


class Throughput(NamedTuple):
    rays_per_s: float  # of the best pass
    n_capped: int  # lanes stopped by the step cap in the last pass
    pass_times_s: List[float]
    film: torch.Tensor  # of the last pass


def _render_throughput(medium, camera, params, W, H, spp, bb=None, seed=SEED, reps=3,
                       wave_fn=mk.render_wave) -> Throughput:
    """One W*H-lane wave a launch, `spp` waves a pass into one film: one
    warm-up pass, then `reps` timed passes, each ending in a forced
    device-to-host read of the film's checksum."""
    dev = medium.device

    def one_pass():
        film = torch.zeros((H, W, 4), dtype=torch.float32, device=dev)
        # Accumulate on the device: a host read per wave would wait for it.
        ncap = torch.zeros((), dtype=torch.int64, device=dev)
        for w in range(1, spp + 1):
            ncap += _wave(wave_fn, medium, camera, params, bb, film, seed, w)[1]
        return film, ncap, float(film[..., :3].sum())  # the forced read

    one_pass()  # warm-up: first-launch and allocator effects
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        film, ncap, chk = one_pass()
        times.append(time.perf_counter() - t0)
        _gate(np.isfinite(chk), "non-finite radiance")
    return Throughput(W * H * spp / min(times), int(ncap), [round(t, 6) for t in times], film)


def bench_primary(dev, size=256, waves=16, reps=5) -> Throughput:
    """The flagship: 256x256 x 16 waves, max_iters 4096, packed rows, best of
    5 passes with the full spread recorded."""
    medium, camera = _flagship(dev, size)
    return _render_throughput(medium, camera, _wdas_params(), size, size, waves, reps=reps)


def primary_line(res: Throughput, device: dict, build_s, waves=16, reps=5) -> dict:
    """The bench's one JSON line for the primary's result."""
    return {
        "metric": METRIC,
        "value": round(res.rays_per_s, 1),
        "unit": UNIT,
        "method": (
            f"best of {reps} transfer-forced passes of {waves} waves, one render_wave launch a "
            f"{res.film.shape[0] * res.film.shape[1]}-lane wave into one film on the device; the kernel "
            "library built and loaded before any timing (build_s); pass_times_s records all passes"
        ),
        "pass_times_s": res.pass_times_s,
        "device": device,
        "build_s": build_s,
    }


def _big_cloud_cached(out_dir, n=512):
    """big_cloud(n), cached as .npy under the bench's output directory
    (generating 512^3 on the host takes minutes)."""
    path = os.path.join(out_dir, f"big_cloud_{n}.npy")
    h = n // 2
    if os.path.exists(path):
        return dense_grid_from_array(np.load(path), origin_ijk=(-h, -h, -h), voxel_size=1.0)
    g = big_cloud(n=n)
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, g.data.numpy())
    os.replace(tmp, path)
    return g


def bench_big_cloud(out, out_dir, dev, size=256, waves=8, reps=2, n=512):
    """The 512^3 cloud (12% occupancy), packed (the 4.33 GB fused table) and
    unpacked (the dense kernel from the grid's own 0.54 GB array)."""
    grid = _big_cloud_cached(out_dir, n)
    cam = _camera(size, size, (900.0, 0.0, 0.0), vfov=40.0, device=dev)
    for packed in (True, False):
        key = f"big_cloud_{n}_{'packed' if packed else 'raw'}"
        _reset_peak(dev)
        med = Medium.from_grids(grid, pack=packed, device=dev)
        res = _render_throughput(med, cam, _wdas_params(), size, size, waves, reps=reps)
        out[f"{key}_rays_per_s"] = round(res.rays_per_s, 1)
        out["peak_mem_gb"][key] = _peak(dev, 1e9)
        # Free one medium before the next is built, or the peak holds both.
        del med, res
        _free(dev)
    out["big_cloud_method"] = (
        "raw: pack=False, the dense instantiation of render_wave_kernel reading the grid's own "
        "array (the JAX bench's raw path is its XLA loop; the port's plain loop never runs on the card)"
    )


def bench_fire(out, dev, size=256, waves=8, reps=2, sweep=(2048, 4096, 8192), low_iters=4096):
    """The fire transport on fire_plume(96, 28): the max_iters sweep on the
    misaligned temperature grid, the aligned grid (16-wide rows) and the
    low-scattering transport."""
    dens, temp = fire_plume(height=96, radius=28.0)
    bb = _blackbody(dev)
    cam = _fire_camera(size, dev)
    _reset_peak(dev)
    med = Medium.from_grids(dens, temp, device=dev)
    _gate(med.density_rows.shape[1] == 8 and med.temperature_rows is not None,
          "the misaligned fire medium is not 8-wide rows with a temperature table")
    sweep_out = {}
    for mi in sweep:
        res = _render_throughput(med, cam, _fire_params(max_iters=mi), size, size, waves, bb=bb, reps=reps)
        sweep_out[str(mi)] = {"rays_per_s": round(res.rays_per_s, 1), "capped_lanes": res.n_capped}
    out["fire_max_iters_sweep"] = sweep_out
    out["fire_rays_per_s"] = sweep_out[str(max(sweep))]["rays_per_s"]
    out["fire_capped_lanes"] = sweep_out[str(max(sweep))]["capped_lanes"]
    out["peak_mem_gb"]["fire_max_iters_sweep"] = _peak(dev, 1e9)

    # The same transport with an alignment-compatible temperature grid: its
    # corners fold into 16-wide fused rows.
    _reset_peak(dev)
    med_al = Medium.from_grids(dens, _aligned(temp), device=dev)
    _gate(med_al.density_rows.shape[1] == 16, "the aligned fire medium is not 16-wide rows")
    res = _render_throughput(med_al, cam, _fire_params(max_iters=max(sweep)), size, size, waves, bb=bb, reps=reps)
    out["fire_aligned_fused_rays_per_s"] = round(res.rays_per_s, 1)
    out["peak_mem_gb"]["fire_aligned_fused"] = _peak(dev, 1e9)
    del med_al, res

    # fire_lowscattering.json transport (sigma_s=0.09: near-single-scattering
    # emissive paths) on the same plume.
    low = dataclasses.replace(_fire_params(max_iters=low_iters), sigma_s=0.09, max_depth=1_000_000)
    _reset_peak(dev)
    res = _render_throughput(med, cam, low, size, size, waves, bb=bb, reps=reps)
    out["fire_lowscattering_rays_per_s"] = round(res.rays_per_s, 1)
    out["fire_lowscattering_capped_lanes"] = res.n_capped
    out["peak_mem_gb"]["fire_lowscattering"] = _peak(dev, 1e9)
    out["fire_method"] = (
        "every fire cell on render_wave_kernel: the misaligned temperature grid as 8-wide rows plus "
        "the temperature gather (the JAX bench puts that medium on its XLA loop), the aligned one as "
        "16-wide rows"
    )


def _train_rays_per_s(step, grids, batch, seed, dev, lanes, chain, chains):
    """Warm-up step, then `chains` chains of `chain` device-resident steps,
    one forced read of the loss per chain: lanes * chain / best chain."""
    opt = inv.make_optimizer(grids)
    grids, opt, loss = step(grids, opt, *batch, (seed, 1))
    _gate(np.isfinite(float(loss)), "non-finite train loss")  # warm-up
    best = None
    for rep in range(chains):
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(chain):
            grids, opt, loss = step(grids, opt, *batch, (seed, 2 + rep * chain + i))
        value = float(loss)  # forces completion of the chain
        dt = time.perf_counter() - t0
        _gate(np.isfinite(value), "non-finite train loss")
        best = dt if best is None else min(best, dt)
    _gate(all(bool(torch.isfinite(p).all()) for p in inv.grid_leaves(grids)), "non-finite grids after training")
    return lanes * chain / best


def bench_train(out, dev, size=128, k=8, n_iters=1024, chain=4, chains=3):
    """Forward + backward (path replay) train steps: the density step on the
    flagship and the joint density + temperature step on the plume."""
    batch = (torch.from_numpy(pixel_coords(size, size)).to(dev),
             torch.arange(size * size, dtype=torch.int32, device=dev),
             torch.zeros((size * size, 3), dtype=torch.float32, device=dev))
    lanes = size * size * k

    _reset_peak(dev)
    base = Medium.from_grids(fog_sphere(radius=30.0, falloff=6.0), pack=False, device=dev)
    grids = inv.OptimizableGrids(inv.param_from_density(base.density.data).clone().requires_grad_(True))
    step = inv.make_train_step(base, _wdas_params(max_iters=n_iters), _camera(size, size, (110.0, 0.0, 0.0), device=dev),
                               None, n_iters=n_iters, samples_per_step=k, use_prb=True, pack=True)
    out["train_fwd_bwd_rays_per_s"] = round(_train_rays_per_s(step, grids, batch, 3, dev, lanes, chain, chains), 1)
    out["peak_mem_gb"]["train_fwd_bwd"] = _peak(dev, 1e9)
    out["train_method"] = (
        f"{k} spp/step, best-of-{chains} chains of {chain} device-resident steps, "
        "one forced transfer per chain"
    )
    del base, grids, step

    # The joint density + temperature step (emissive medium, dual buffer).
    _reset_peak(dev)
    dens_j, temp_j = fire_plume(height=96, radius=28.0)
    base_j = Medium.from_grids(dens_j, temp_j, pack=False, device=dev)
    em_params = dataclasses.replace(_fire_params(max_iters=n_iters), max_depth=10_000)
    grids_j = inv.OptimizableGrids(inv.param_from_density(base_j.density.data).clone().requires_grad_(True),
                                   base_j.temperature.data.clone().requires_grad_(True))
    step_j = inv.make_train_step(base_j, em_params, _fire_camera(size, dev), _blackbody(dev), n_iters=n_iters,
                                 samples_per_step=k, use_prb=True, pack=True, dual_buffer=True)
    out["train_joint_emissive_rays_per_s"] = round(
        _train_rays_per_s(step_j, grids_j, batch, 5, dev, lanes, chain, chains), 1)
    out["peak_mem_gb"]["train_joint_emissive"] = _peak(dev, 1e9)


def bench_full(out_dir, dev, sizes=None) -> dict:
    """--full's cells; sizes: keyword arguments of bench_big_cloud,
    bench_fire and bench_train under those names (default bench.py's)."""
    sizes = sizes or {}
    out = {"peak_mem_gb": {}}
    bench_big_cloud(out, out_dir, dev, **sizes.get("big_cloud", {}))
    bench_fire(out, dev, **sizes.get("fire", {}))
    bench_train(out, dev, **sizes.get("train", {}))
    return out


def bench_render1024(out_dir, dev, size=1024, waves=64, chunk=65536) -> dict:
    """A 1024x1024 x 64-wave render through the command line, cli.main
    in-process (checkpointing, preview PNG and pixel chunking on), cold and
    warm, with the run's peak device memory. Files under OUT/render1024/."""
    from . import cli
    from .io.png import read_png

    d = os.path.join(out_dir, "render1024")
    os.makedirs(d, exist_ok=True)
    scene = {
        "seed": SEED, "output_size": [size, size], "tile_size": [8, 8],
        "num_waves": waves, "num_workers": 1,
        "camera_parameters": {
            "position": [110.0, 0.0, 0.0], "look": [0.0, 0.0, 0.0],
            "up": [0.0, 1.0, 0.0], "vfov_deg": 35.0, "imaging_ratio": 0.1,
        },
        "worker_parameters": {
            "single_pixel": {"enabled": False, "coord": [0, 0]},
            "infinite_light": {"xyz": [4.382, 3.509, 17.603], "multiplier": 0.14},
            "distant_light": {"xyz": [0.95047, 1.0, 1.08883],
                              "inv_direction": [0.5826, 0.766, 0.2717],
                              "multiplier": 50.0},
            "use_jitter": True, "max_depth": 100,
        },
        "volume_path": "unused.nvdb",
        "volume_parameters": {
            "sigma_a": 0.0, "sigma_s": 0.15, "henyey_greenstein_g": 0.4,
            "le_scale": 0.0, "temperature_offset": 300.0,
            "temperature_scale": 40.0,
        },
    }
    sp = os.path.join(d, "scene1024.json")
    with open(sp, "w") as f:
        json.dump(scene, f)
    out_png, ck = os.path.join(d, "out.png"), os.path.join(d, "ck.npz")

    def run_once():
        for stale in (out_png, ck):  # a stale checkpoint would resume and skip waves
            if os.path.exists(stale):
                os.remove(stale)
        t0 = time.perf_counter()
        rc = cli.main([
            sp, out_png, "--procedural", "sphere", "--max-iters", "4096",
            "--chunk-pixels", str(chunk), "--checkpoint", ck,
            "--preview", os.path.join(d, "preview.png"), *(["--cpu"] if dev.type == "cpu" else []),
        ])
        wall = time.perf_counter() - t0
        _gate(rc == 0, f"cli.main returned {rc}")
        return wall

    _reset_peak(dev)
    wall = run_once()  # cold: the first launches in this process (the library is already built)
    warm = run_once()
    film = np.load(ck)["film"]
    img = read_png(out_png)
    _gate(np.isfinite(film).all() and (film[..., 3] == waves).all(), "render1024: film not finite or wrong weights")
    _gate(img.shape == (size, size, 3) and img.max() > 0, "render1024: image missing or black")
    rays = size * size * waves
    return {
        "render_1024_wall_s": round(wall, 2),
        "render_1024_rays_per_s": round(rays / wall, 1),
        "render_1024_warm_wall_s": round(warm, 2),
        "render_1024_warm_rays_per_s": round(rays / warm, 1),
        "render_1024_waves": waves,
        "render_1024_peak_hbm_mb": _peak(dev, 1e6),
        "render_1024_method": (
            f"in-process CLI (vpt-torch scene.json out.png --procedural sphere --chunk-pixels {chunk} "
            "--checkpoint --preview), end-to-end wall clock incl. the first launches, PNG and "
            "checkpoints; the kernel library built before (build_s)"
        ),
    }


def agreement(a, b, am, bm, lo, hi, tag=""):
    """bench.py's gates of one plain-against-kernel cross-check.

    a, b: each lane's wave-1 radiance [N, 3] by the plain version and the
    kernel; am, bm: their 8-wave mean images; lo, hi: the plain version's
    per-channel sample range pooled over its 8 waves. Bitwise equality is
    the wrong metric: FMA contraction and last-ulp transcendentals flip
    knife-edge events on a few lanes, and a flipped event re-rolls one Monte
    Carlo sample. So: lane-close fraction > 0.95 (rtol 1e-3, atol 1e-4),
    relative mean difference < 1e-3, and every disagreeing lane inside the
    per-sample range (slack 1e-5 + 1e-3 * (hi - lo)). Returns the keys;
    raises GateFailed."""
    out = {}
    lane_bitwise = float(np.mean(np.all(a == b, axis=-1)))
    close_mask = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(-1)
    lane_close = float(np.mean(close_mask))
    rel_mean = abs(am.mean() - bm.mean()) / max(abs(am.mean()), 1e-9)
    out[f"{tag}lane_bitwise_fraction"] = round(lane_bitwise, 4)
    out[f"{tag}lane_close_fraction"] = round(lane_close, 4)
    out[f"{tag}mean_rel_diff"] = round(float(rel_mean), 6)
    scale = max(float(np.abs(a).mean()), 1e-9)
    diff = np.abs(a - b).max(-1)
    bad = diff[~close_mask]
    if bad.size:
        out[f"{tag}disagree_p50_rel"] = round(float(np.percentile(bad, 50)) / scale, 4)
        out[f"{tag}disagree_p99_rel"] = round(float(np.percentile(bad, 99)) / scale, 4)
        out[f"{tag}disagree_max_abs"] = round(float(bad.max()), 4)
        slack = 1e-5 + 1e-3 * (hi - lo)
        bad_vals = b[~close_mask]
        in_range = bool(((bad_vals >= lo - slack) & (bad_vals <= hi + slack)).all())
        out[f"{tag}disagree_within_sample_range"] = in_range
        out[f"{tag}sample_range_lo"] = [round(float(v), 4) for v in lo]
        out[f"{tag}sample_range_hi"] = [round(float(v), 4) for v in hi]
        _gate(in_range, f"{tag} disagreeing lane outside per-sample range")
    _gate(rel_mean < 1e-3, f"{tag} mean mismatch: {rel_mean}")
    _gate(lane_close > 0.95, f"{tag} lane agreement too low: {lane_close}")
    return out


def verify_scene(out, tag, medium, camera, params, bb=None, size=256, timed_waves=4, reps=2,
                 compared_waves=8):
    """One plain-against-kernel cross-check: each side's rays/s (bench.py's
    pass method) and seconds, then `compared_waves` waves of each side and
    agreement()'s gates."""
    images, lane_images = {}, {}
    lo = hi = None
    for name, wave_fn in (("plain", mk.render_wave_plain), ("kernel", mk.render_wave)):
        t0 = time.perf_counter()
        res = _render_throughput(medium, camera, params, size, size, timed_waves, bb=bb, reps=reps,
                                 wave_fn=wave_fn)
        # Lane agreement compares ONE wave draw for draw; the mean gate
        # compares the averages of all waves (a knife-edge flip re-rolls a
        # lane's sample, so one wave's mean difference is Monte Carlo noise).
        acc = None
        for w in range(1, compared_waves + 1):
            L, _ = wave_radiance(wave_fn, medium, camera, params, size, size, bb=bb, w=w)
            if w == 1:
                lane_images[name] = L
            if name == "plain":
                # The per-lane bound's support: every plain wave's samples.
                lo = L.min(0) if lo is None else np.minimum(lo, L.min(0))
                hi = L.max(0) if hi is None else np.maximum(hi, L.max(0))
            acc = L if acc is None else acc + L
        images[name] = acc / compared_waves
        out[f"{tag}{name}_rays_per_s"] = round(res.rays_per_s, 1)
        out[f"{tag}{name}_pass_times_s"] = res.pass_times_s
        out[f"{tag}{name}_wall_s"] = round(time.perf_counter() - t0, 2)
    out.update(agreement(lane_images["plain"], lane_images["kernel"], images["plain"], images["kernel"],
                         lo, hi, tag))
    return out


def bench_verify(dev, size=256, timed_waves=4, reps=2, compared_waves=8, fire_iters=4096) -> dict:
    """The plain version against the kernel on the flagship scattering scene
    and on the emissive fire transport with the aligned temperature grid
    (16-wide fused rows)."""
    kw = dict(size=size, timed_waves=timed_waves, reps=reps, compared_waves=compared_waves)
    out = {}
    medium, camera = _flagship(dev, size)
    verify_scene(out, "", medium, camera, _wdas_params(), **kw)
    del medium

    dens, temp = fire_plume(height=96, radius=28.0)
    med_fire = Medium.from_grids(dens, _aligned(temp), device=dev)
    _gate(med_fire.density_rows.shape[1] == 16, "the aligned fire medium is not 16-wide rows")
    verify_scene(out, "fire_", med_fire, _fire_camera(size, dev), _fire_params(max_iters=fire_iters),
                 bb=_blackbody(dev), **kw)
    return out


def _write_json(path, rec, merge=False):
    """Write rec to path (merged over the file's keys when merge)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if merge and os.path.exists(path):
        with open(path) as f:
            rec = {**json.load(f), **rec}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None, sizes=None):
    """The bench; sizes: keyword arguments of the bench functions under
    "primary", "big_cloud", "fire", "train", "verify" and "render1024"
    (default bench.py's sizes: tests pass smaller ones)."""
    ap = argparse.ArgumentParser(prog="python -m volume_path_tracer_tpu_torch.bench")
    ap.add_argument("--full", action="store_true",
                    help="also run the big-grid, fire and train cells -> OUT/bench_extra.json")
    ap.add_argument("--verify", action="store_true",
                    help="plain version against the kernel, agreement and timing -> OUT/bench_verify.json")
    ap.add_argument("--render1024", action="store_true",
                    help="1024x1024 CLI render, end to end -> OUT/bench_extra.json")
    ap.add_argument("--out", default=DEFAULT_OUT, metavar="DIR",
                    help=f"directory of every file the bench writes (default {DEFAULT_OUT})")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the plain versions (default: the CUDA device)")
    args = ap.parse_args(argv)
    sizes = sizes or {}

    dev = resolve_device("cpu" if args.cpu else None)
    device = card(dev)
    build_s = build_kernels(dev)
    extra_path = os.path.join(args.out, "bench_extra.json")

    if args.render1024:
        rec = bench_render1024(args.out, dev, **sizes.get("render1024", {}))
        rec.update(device=device, build_s=build_s)
        _write_json(extra_path, rec, merge=True)
        print(json.dumps(rec), flush=True)
        return 0

    if args.verify:
        v = bench_verify(dev, **sizes.get("verify", {}))
        v.update(device=device, build_s=build_s)
        _write_json(os.path.join(args.out, "bench_verify.json"), v)
        print(json.dumps(v), flush=True)
        return 0

    _reset_peak(dev)
    primary = sizes.get("primary", {})
    res = bench_primary(dev, **primary)
    primary_peak = _peak(dev, 1e9)
    line = primary_line(res, device, build_s, primary.get("waves", 16), primary.get("reps", 5))
    del res
    _free(dev)

    if args.full:
        extra = bench_full(args.out, dev, sizes)
        extra["primary_rays_per_s"] = line["value"]
        extra["peak_mem_gb"]["primary"] = primary_peak
        extra.update(device=device, build_s=build_s)
        # Merged over the file: --render1024 contributes its keys separately.
        extra = _write_json(extra_path, extra, merge=True)
        print(json.dumps(extra), flush=True)

    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
