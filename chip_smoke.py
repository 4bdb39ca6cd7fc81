#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py        (from the repository root)

Phases, each stopping the run with a non-zero exit on failure:

  1. device   require CUDA; print the card's name and power limit
  2. build    compile csrc/trace_lanes.cu with nvcc; print the seconds taken
  3. kernel   the CUDA lane kernel against its plain PyTorch version on the
              card: one step on a mid-flight flagship batch (every state
              field, lane by lane), then full traces on three small scenes
  4. flagship the main path, Scene.from_config -> render -> film_to_srgb_u8
              -> write_png, on the flagship configuration (wdas_cloud
              transport, fog_sphere(30, 6) = 77^3, 256x256 at 16 waves);
              rays/s, launch counts, n_capped, finiteness; then one wave's
              full trace by the kernel against the plain version, the
              kernel's device time, and its bound
  5. fire     the same path on bench.py's fire cell (fire transport,
              fire_plume(96, 28), 256x256, 4 waves): the misaligned
              temperature grid (8-wide rows plus the temperature gather) and
              the aligned one (16-wide rows)
  6. 512^3    big_cloud(512) with its 4.3 GB fused table, 256x256, 2 waves;
              rays/s and peak device memory (the generated grid is cached
              in chip_smoke_out/ for later runs)
  7. cli      cli.main on the procedural plume, 256x256, 2 waves; the PNG
              is read back

The line before the last is the kernels' JSON record (launches on the main
path, error against the plain version, times and bound); the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX. Images and the CLI's
scene file go to chip_smoke_out/ (listed in .gitignore).
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chip_smoke_out")

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 (non-tensor) rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Float operations per lane-step of csrc/trace_lanes.cu, counted from the
# source for a non-emissive collision or crossing step (draws, free flight,
# gather point, trilinear weights and dot, segment derivation, event).
OPS_PER_LANE_STEP = 150

# The flagship transport (scenes/wdas_cloud.json, as bench.py pins it).
WDAS_SCENE = {
    "worker_parameters": {
        "single_pixel": {"enabled": False, "coord": [0, 0]},
        "infinite_light": {"xyz": [4.382, 3.509, 17.603], "multiplier": 0.14},
        "distant_light": {"xyz": [0.95047, 1.0, 1.08883], "multiplier": 50.0,
                          "inv_direction": [0.5826, 0.7660, 0.2717]},
        "use_jitter": True,
        "max_depth": 100,
    },
    "volume_parameters": {
        "sigma_s": 0.15, "sigma_a": 0.0, "henyey_greenstein_g": 0.4,
        "le_scale": 0.0, "temperature_offset": 300.0, "temperature_scale": 40.0,
    },
    "seed": 10, "output_size": [256, 256], "tile_size": [16, 16], "num_waves": 16,
    "num_workers": 1, "volume_path": "wdas_cloud.nvdb",
    "camera_parameters": {"position": [110.0, 0.0, 0.0], "look": [0.0, 0.0, 0.0],
                          "up": [0.0, 1.0, 0.0], "vfov_deg": 35.0, "imaging_ratio": 0.1},
}
FLAGSHIP_MAX_ITERS = 4096

# bench.py's fire cell: scenes/fire.json transport, fire_plume(96, 28) and
# the camera of bench.py:237, 256x256.
FIRE_SCENE = dict(
    WDAS_SCENE, num_waves=4, volume_path="fire.nvdb",
    volume_parameters={
        "sigma_s": 0.9, "sigma_a": 2.0, "henyey_greenstein_g": 0.7, "le_scale": 4e-8,
        "temperature_offset": 300.0, "temperature_scale": 43.0,
    },
    worker_parameters=dict(
        WDAS_SCENE["worker_parameters"], max_depth=1_000_000,
        infinite_light={"xyz": [0.25, 0.25, 0.5], "multiplier": 10.0},
        distant_light={"xyz": [0.95047, 1.0, 1.08883], "multiplier": 20.0,
                       "inv_direction": [0.5, 1.0, 0.0]},
    ),
    camera_parameters=dict(WDAS_SCENE["camera_parameters"], position=[170.0, 48.0, 0.0],
                           look=[0.0, 48.0, 0.0], vfov_deg=37.0),
)
FIRE_MAX_ITERS = 8192

FOG_PARAMS = dict(
    sigma_a=0.0, sigma_s=0.15, hg_g=0.4, le_scale=0.0,
    temperature_offset=300.0, temperature_scale=40.0,
    infinite_xyz=(4.382, 3.509, 17.603), infinite_multiplier=0.14,
    distant_xyz=(0.95047, 1.0, 1.08883), distant_multiplier=50.0,
    distant_inv_direction=(0.5826, 0.7660, 0.2717), max_depth=100, max_iters=512,
)
FIRE_PARAMS = dict(
    sigma_a=2.0, sigma_s=0.9, hg_g=0.7, le_scale=4e-8,
    temperature_offset=300.0, temperature_scale=43.0,
    infinite_xyz=(0.25, 0.25, 0.5), infinite_multiplier=10.0,
    distant_xyz=(0.95047, 1.0, 1.08883), distant_multiplier=20.0,
    distant_inv_direction=(0.5, 1.0, 0.0), max_depth=1_000_000, max_iters=2048,
)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def phase(name):
    print(f"== {name}", flush=True)


def gpu_name_and_limit():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace_statistic(L_k, nc_k, L_p, nc_p, what):
    """Hold a kernel trace to the plain one by the statistic of
    tests/test_megakernel.py: lane-close > 0.95 at rtol 1e-4, atol 1e-5 (FMA
    contraction and last-ulp transcendentals flip knife-edge events on a few
    lanes), channel means within 5%, equal n_capped."""
    import numpy as np

    close = float(np.isclose(L_k, L_p, rtol=1e-4, atol=1e-5).all(-1).mean())
    rel = np.abs(L_k.mean(0) - L_p.mean(0)) / (np.abs(L_p.mean(0)) + 1e-9)
    print(f"trace {what}: lane-close {close:.4f}, channel rel diff {rel.max():.2e}, "
          f"n_capped {nc_k} vs {nc_p}")
    check(close > 0.95, f"{what}: lane-close {close} <= 0.95")
    check(bool((rel < 0.05).all()), f"{what}: channel means differ by {rel}")
    check(nc_k == nc_p, f"{what}: n_capped {nc_k} != {nc_p}")


def big_cloud_cached(n):
    """big_cloud(n), cached as .npy in chip_smoke_out/ under the hash of the
    generator's source (generating 512^3 on the host takes minutes)."""
    import hashlib

    import numpy as np

    from volume_path_tracer_tpu_torch.grids import procedural
    from volume_path_tracer_tpu_torch.grids.grid import dense_grid_from_array

    with open(procedural.__file__, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    path = os.path.join(OUT_DIR, f"big_cloud_{n}-{tag}.npy")
    if os.path.exists(path):
        h = n // 2
        return dense_grid_from_array(np.load(path), origin_ijk=(-h, -h, -h), voxel_size=1.0), True
    grid = procedural.big_cloud(n=n)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, grid.data)
    os.replace(tmp, path)
    return grid, False


def profile_pass(scene, png_path, best_s, what):
    """Where one pass of the main path spends its time (torch.profiler,
    CUPTI): device time summed over the kernels alone (a PyTorch op's own
    entry repeats its kernels' time, so only device events count), the
    kernel's share, the device busy share, and host calls per wave."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_passes(scene, 1, png_path)
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev)
    kern_us = sum(e.self_device_time_total for e in dev if "trace_lanes_kernel" in e.key)
    check(kern_us > 0, f"{what}: the profiler saw no trace_lanes device time")

    def calls(key):
        return sum(e.count for e in ka if e.key == key)

    waves = scene.num_waves
    print(f"profile of one {what} pass: device time {dev_us / 1e3:.3f} ms (trace_lanes "
          f"{kern_us / 1e3:.3f} ms = {kern_us / dev_us:.3f} of it), device busy share "
          f"{dev_us / 1e6 / wall:.3f} of the profiled {wall * 1e3:.1f} ms and "
          f"{dev_us / 1e6 / best_s:.3f} of the best unprofiled pass; per wave: "
          f"{calls('cudaLaunchKernel') / waves:.1f} kernel launches, "
          f"{calls('cudaStreamSynchronize') / waves:.1f} stream syncs, "
          f"{calls('cudaMemcpyAsync') / waves:.1f} copies")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:70]}")


def render_passes(scene, reps, png_path):
    """Time `reps` full passes of the main path (render -> tonemap -> PNG)."""
    import torch

    from volume_path_tracer_tpu_torch.io.png import write_png
    from volume_path_tracer_tpu_torch.render.renderer import render
    from volume_path_tracer_tpu_torch.utils.color import film_to_srgb_u8

    times, film = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = render(scene)
        img = film_to_srgb_u8(film).cpu().numpy()
        write_png(png_path, img)
        times.append(time.perf_counter() - t0)
    return times, film, img


def main():
    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "volume_path_tracer_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from volume_path_tracer_tpu_torch.grids.grid import dense_grid_from_array
    from volume_path_tracer_tpu_torch.grids.procedural import fire_plume, fog_sphere
    from volume_path_tracer_tpu_torch.models.medium import Medium
    from volume_path_tracer_tpu_torch.render import integrator as integ
    from volume_path_tracer_tpu_torch.render import megakernel as mk
    from volume_path_tracer_tpu_torch.render.renderer import Scene, pixel_coords, render, render_wave_image
    from volume_path_tracer_tpu_torch.utils import rng as vrng
    from volume_path_tracer_tpu_torch.utils.config import loads_configuration
    from volume_path_tracer_tpu_torch.utils.spectral import blackbody_xyz_table

    dev = torch.device("cuda", 0)
    card = gpu_name_and_limit()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    os.makedirs(OUT_DIR, exist_ok=True)

    phase("2 build")
    t0 = time.perf_counter()
    lib_path = mk.build()
    mk._library()
    print(f"build_s {time.perf_counter() - t0:.2f}  ({os.path.basename(lib_path)})")
    with open(lib_path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  " + line.strip())

    # ------------------------------------------------------------------
    phase("3 kernel vs plain")
    flag_cfg = loads_configuration(json.dumps(WDAS_SCENE))
    flag_med = Medium.from_grids(fog_sphere(radius=30.0, falloff=6.0))
    flag = Scene.from_config(flag_cfg, flag_med, max_iters=FLAGSHIP_MAX_ITERS)
    W, H = flag.width, flag.height
    coords = torch.from_numpy(pixel_coords(W, H)).to(dev)
    pids = torch.arange(W * H, dtype=torch.int32, device=dev)
    stream = vrng.mix_stream(flag.seed, 1)
    u_jit = vrng.counter_uniforms(pids, stream, 2**31 - 1, 2)
    o_w, d_w = flag.camera.generate_rays(coords, u_jit * 0.5)
    sf0, si0 = mk.pack_state(integ.init_state(flag_med, o_w, d_w, flag.params))
    streams = integ.lane_streams(stream, W * H, dev)

    # (a) one step on a mid-flight state (20 plain steps in)
    sf_mid, si_mid = mk.trace_lanes_plain(flag_med, flag.params, None, sf0, si0, pids, streams, 20)
    kf, ki = mk.trace_lanes(flag_med, flag.params, None, sf_mid, si_mid, pids, streams, 1)
    torch.cuda.synchronize()
    pf, pi = mk.trace_lanes_plain(flag_med, flag.params, None, sf_mid, si_mid, pids, streams, 1)
    # rtol 1e-5: FMA contraction and last-ulp transcendentals; atol 1e-6 for
    # fields that are ~0 (radiance, phase) where a relative bound is void.
    f_ok = torch.isclose(kf, pf, rtol=1e-5, atol=1e-6).all(0)
    i_ok = (ki == pi).all(0)
    one_step_agree = float(f_ok.float().mean())
    one_step_max_abs = float((kf - pf).abs().max())
    alive_mid = int((si_mid[1] != integ.DONE).sum())
    print(f"one step (mid-flight, {alive_mid} of {W * H} lanes alive): agree {one_step_agree:.6f}, "
          f"int fields equal where floats agree: {bool(i_ok[f_ok].all())}, max_abs_err {one_step_max_abs:.3e}")
    check(one_step_agree >= 0.99, f"one-step agreement {one_step_agree} < 0.99")
    check(bool(i_ok[f_ok].all()), "integer fields differ where the float fields agree")

    # (b) full traces on the three scenes of tests/test_megakernel.py
    dens, temp = fire_plume(height=40, radius=10.0)
    temp_al = dense_grid_from_array(temp.data, temp.origin_ijk, temp.voxel_size, (0.0, 0.0, 0.0))
    bb = torch.from_numpy(blackbody_xyz_table()).to(dev)
    cases = [
        ("fog_sphere", Medium.from_grids(fog_sphere(radius=12.0, falloff=3.0)),
         integ.IntegratorParams(**FOG_PARAMS), None, (-14, 14), (-14, 14)),
        ("fire_plume_8wide", Medium.from_grids(dens, temp),
         integ.IntegratorParams(**FIRE_PARAMS), bb, (5, 35), (-10, 10)),
        ("fire_plume_16wide", Medium.from_grids(dens, temp_al),
         integ.IntegratorParams(**FIRE_PARAMS), bb, (5, 35), (-10, 10)),
    ]
    N = 2048
    for name, med, prm, bbt, yr, zr in cases:
        rng = np.random.default_rng(0)
        o = np.stack([np.full(N, -40.0), rng.uniform(*yr, N), rng.uniform(*zr, N)], -1)
        o = torch.tensor(o, dtype=torch.float32, device=dev)
        d = torch.tensor([[1.0, 0.0, 0.0]], device=dev).expand(N, 3).contiguous()
        lp = torch.arange(N, dtype=torch.int32, device=dev)
        s = vrng.mix_stream(3, 1)
        L_k, _, nc_k = mk.trace_rays_fused(med, prm, bbt, o, d, lp, s)
        sfa, sia = mk.pack_state(integ.init_state(med, o, d, prm))
        sfp, sip = mk.trace_lanes_plain(med, prm, bbt, sfa, sia, lp, integ.lane_streams(s, N, dev), prm.max_iters)
        trace_statistic(L_k.cpu().numpy(), int(nc_k), sfp[10:13].T.cpu().numpy(),
                        int((sip[1] != integ.DONE).sum()),
                        f"{name} ({med.density_rows.shape[1]}-wide rows, {N} lanes)")

    # ------------------------------------------------------------------
    phase("4 flagship main path")
    png = os.path.join(OUT_DIR, "flagship.png")
    render_passes(flag, 1, png)  # warm-up: first-call allocations and caches
    mk.LAUNCHES = 0
    mk.PLAIN_LAUNCHES = 0
    times, film, img = render_passes(flag, 3, png)
    flag_launches, flag_plain = mk.LAUNCHES, mk.PLAIN_LAUNCHES
    rays = W * H * flag.num_waves
    flag_rays_s = rays / min(times)
    finite = bool(torch.isfinite(film).all())
    weights_ok = bool((film[..., 3] == flag.num_waves).all())
    ncap = sum(int(render_wave_image(flag, w, return_ncap=True)[1])
               for w in range(1, flag.num_waves + 1))
    print(f"flagship 256x256x16: rays/s {flag_rays_s:.1f} (best of 3; pass seconds "
          f"{[round(t, 4) for t in times]}) on {card}")
    print(f"kernel launches {flag_launches} (3 passes x 16 waves), plain launches {flag_plain}, "
          f"n_capped (16 waves) {ncap}, film finite {finite}, weights == waves {weights_ok}, "
          f"image mean {img.mean():.2f}")
    check(ncap == 0, f"{ncap} flagship rays truncated at the step cap")
    check(flag_launches > 0, "the main path never launched the kernel")
    check(flag_plain == 0, "the main path ran the plain version")
    check(finite and weights_ok, "flagship film is not finite or has wrong weights")
    check(img.max() > 0, "flagship image is black")

    # The kernel alone at the main path's shapes (one wave's trace, wave-1
    # inputs), held against the plain version on the same inputs.
    from torch.profiler import ProfilerActivity, profile

    def kernel_wave(tap=None):
        return mk.trace_lanes(flag_med, flag.params, None, sf0, si0, pids, streams,
                              FLAGSHIP_MAX_ITERS, row_tap=tap)

    sf_k, si_k = kernel_wave()
    wrapper_ms = cuda_ms(kernel_wave, 10)
    t0 = time.perf_counter()
    sf_p, si_p = mk.trace_lanes_plain(flag_med, flag.params, None, sf0, si0, pids, streams,
                                      FLAGSHIP_MAX_ITERS)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    trace_statistic(sf_k[10:13].T.cpu().numpy(), int((si_k[1] != integ.DONE).sum()),
                    sf_p[10:13].T.cpu().numpy(), int((si_p[1] != integ.DONE).sum()),
                    f"flagship wave ({W * H} lanes, max_steps {FLAGSHIP_MAX_ITERS})")
    # The kernel's own device time: CUPTI kernel records, without the
    # wrapper's state clones, parameter copies and casts.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            kernel_wave()
        torch.cuda.synchronize()
    kev = [e for e in prof.key_averages() if "trace_lanes_kernel" in e.key]
    n_kev = sum(e.count for e in kev)
    check(n_kev == 10, f"the profiler saw {n_kev} of 10 kernel launches")
    kernel_ms = sum(e.self_device_time_total for e in kev) / n_kev / 1e3
    # The bound counts each byte once: the state read and written, pixel ids
    # and streams (int32), and every table row the run reads, as the kernel
    # itself marks them (row_tap); the parameter arrays (< 200 B) are left out.
    tap = torch.zeros(flag_med.density_rows.shape[0], dtype=torch.uint8, device=dev)
    kernel_wave(tap)
    rows_read = int(tap.sum())
    lane_steps = int(si_k[2].to(torch.int64).sum())
    max_steps_taken = int(si_k[2].max())
    row_bytes = flag_med.density_rows.shape[1] * 4
    state_bytes = (len(mk.STATE_F32) + len(mk.STATE_I32)) * 4 * 2 + 8
    bytes_moved = W * H * state_bytes + rows_read * row_bytes
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = lane_steps * OPS_PER_LANE_STEP / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"trace_lanes one flagship wave ({W * H} lanes): kernel {kernel_ms:.4f} ms (device time, "
          f"mean of 10), wrapper {wrapper_ms:.4f} ms (CUDA events, mean of 10); plain version "
          f"{plain_ms:.1f} ms; lane-steps {lane_steps} (longest lane {max_steps_taken}); "
          f"rows read {rows_read} of {flag_med.density_rows.shape[0]}; bound {bound_ms:.5f} ms "
          f"({'bytes' if bytes_ms >= ops_ms else 'operations'}: {bytes_moved} B = "
          f"{W * H * state_bytes} B state + {rows_read * row_bytes} B rows, {bytes_ms:.5f} ms; "
          f"{lane_steps * OPS_PER_LANE_STEP} fp32 ops, {ops_ms:.5f} ms)")
    del film, sf_k, si_k, sf_p, si_p, tap

    profile_pass(flag, os.path.join(OUT_DIR, "flagship_profiled.png"), min(times), "flagship")

    # ------------------------------------------------------------------
    phase("5 fire")
    del flag, flag_med
    torch.cuda.empty_cache()
    fire_cfg = loads_configuration(json.dumps(FIRE_SCENE))
    f_dens, f_temp = fire_plume(height=96, radius=28.0)
    f_temp_al = dense_grid_from_array(f_temp.data, f_temp.origin_ijk, f_temp.voxel_size, (0.0, 0.0, 0.0))
    fire_rays_s = {}
    for width, temp_grid in ((8, f_temp), (16, f_temp_al)):
        med = Medium.from_grids(f_dens, temp_grid)
        check(med.density_rows.shape[1] == width, f"fire medium has {med.density_rows.shape[1]}-wide rows")
        sc = Scene.from_config(fire_cfg, med, max_iters=FIRE_MAX_ITERS)
        png = os.path.join(OUT_DIR, f"fire_{width}wide.png")
        render(sc, num_waves=1)  # warm-up: the blackbody table, first-call allocations
        mk.LAUNCHES = 0
        mk.PLAIN_LAUNCHES = 0
        times, film, img = render_passes(sc, 2, png)
        launches, plain = mk.LAUNCHES, mk.PLAIN_LAUNCHES
        fire_rays_s[width] = W * H * sc.num_waves / min(times)
        ncap = sum(int(render_wave_image(sc, w, return_ncap=True)[1])
                   for w in range(1, sc.num_waves + 1))
        print(f"fire {width}-wide rows 256x256x{sc.num_waves}: rays/s {fire_rays_s[width]:.1f} (best of 2; "
              f"pass seconds {[round(t, 4) for t in times]}), kernel launches {launches}, plain "
              f"launches {plain}, n_capped ({sc.num_waves} waves, max_iters {FIRE_MAX_ITERS}) {ncap}, "
              f"image mean {img.mean():.2f} on {card}")
        check(launches > 0 and plain == 0, f"fire {width}-wide render did not go through the kernel")
        check(bool(torch.isfinite(film).all()) and bool((film[..., 3] == sc.num_waves).all()),
              f"fire {width}-wide film not finite or has wrong weights")
        check(img.max() > 0, f"fire {width}-wide image is black")
        profile_pass(sc, os.path.join(OUT_DIR, f"fire_{width}wide_profiled.png"), min(times),
                     f"fire {width}-wide")
        del med, sc, film
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    phase("6 big_cloud 512^3")
    t0 = time.perf_counter()
    cloud, cached = big_cloud_cached(512)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cloud_med = Medium.from_grids(cloud)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cloud_cfg = dict(WDAS_SCENE, num_waves=2)
    cloud_cfg["camera_parameters"] = dict(WDAS_SCENE["camera_parameters"],
                                          position=[900.0, 0.0, 0.0], vfov_deg=40.0)
    cloud_scene = Scene.from_config(loads_configuration(json.dumps(cloud_cfg)), cloud_med,
                                    max_iters=FLAGSHIP_MAX_ITERS)
    png = os.path.join(OUT_DIR, "big_cloud_512.png")
    mk.LAUNCHES = 0
    mk.PLAIN_LAUNCHES = 0
    times, film, img = render_passes(cloud_scene, 2, png)
    cloud_rays_s = W * H * 2 / min(times)
    peak = torch.cuda.max_memory_allocated()
    print(f"big_cloud 512^3: {'load from cache' if cached else 'generate'} {gen_s:.1f} s, medium "
          f"build {build_s:.2f} s, table {tuple(cloud_med.density_rows.shape)} = "
          f"{cloud_med.density_rows.numel() * 4 / 1e9:.2f} GB")
    print(f"big_cloud 256x256x2: rays/s {cloud_rays_s:.1f} (best of 2; pass seconds "
          f"{[round(t, 4) for t in times]}), peak device memory {peak / 1e9:.2f} GB, "
          f"kernel launches {mk.LAUNCHES}, plain launches {mk.PLAIN_LAUNCHES} on {card}")
    check(mk.LAUNCHES > 0 and mk.PLAIN_LAUNCHES == 0, "512^3 render did not go through the kernel")
    check(bool(torch.isfinite(film).all()) and img.max() > 0, "512^3 film not finite or black")
    del cloud, cloud_med, cloud_scene, film
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    phase("7 cli")
    from volume_path_tracer_tpu_torch import cli
    from volume_path_tracer_tpu_torch.io.png import read_png

    cli_cfg = dict(FIRE_SCENE, num_waves=4)
    cli_cfg["camera_parameters"] = dict(WDAS_SCENE["camera_parameters"],
                                        position=[120.0, 32.0, 0.0], look=[0.0, 32.0, 0.0])
    cfg_path = os.path.join(OUT_DIR, "fire_scene.json")
    with open(cfg_path, "w") as f:
        json.dump(cli_cfg, f)
    png = os.path.join(OUT_DIR, "cli_plume.png")
    if os.path.exists(png):
        os.remove(png)
    mk.LAUNCHES = 0
    mk.PLAIN_LAUNCHES = 0
    rc = cli.main([cfg_path, png, "--procedural", "plume", "--waves", "2"])
    img = read_png(png)
    print(f"cli: rc {rc}, {png} {img.shape} max {img.max()}, kernel launches {mk.LAUNCHES}, "
          f"plain launches {mk.PLAIN_LAUNCHES}")
    check(rc == 0 and img.shape == (H, W, 3) and img.max() > 0, "cli render failed or black")
    check(mk.LAUNCHES > 0 and mk.PLAIN_LAUNCHES == 0, "cli render did not go through the kernel")

    # ------------------------------------------------------------------
    phase("8 summary")
    print("kernels: " + json.dumps({"trace_lanes": flag_launches, "trace_lanes_plain": flag_plain}))
    print(f"flagship_rays_per_s {flag_rays_s:.1f} fire_8wide_rays_per_s {fire_rays_s[8]:.1f} "
          f"fire_16wide_rays_per_s {fire_rays_s[16]:.1f} big_cloud_512_rays_per_s {cloud_rays_s:.1f}")
    print(card)
    record = {"kernels": [{
        "name": "trace_lanes",
        "route": "cuda",
        "source": "volume_path_tracer_tpu_torch/csrc/trace_lanes.cu",
        "replaces": "volume_path_tracer_tpu/render/megakernel.py:617",
        "launches": flag_launches,
        "max_abs_err": one_step_max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
