#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py        (from the repository root)

Phases, each stopping the run with a non-zero exit on failure:

  1. device   require CUDA; print the card's name and power limit
  2. build    compile csrc/trace_lanes.cu with nvcc and the .nvdb core with
              g++, at once; print the seconds taken, registers and spills of
              each kernel, and the occupancy
  3. kernels  both CUDA kernels against their plain PyTorch versions on the
              card. trace_lanes (state in, state out): one step on a
              mid-flight flagship batch (every state field, lane by lane),
              then full traces on three small scenes. render_wave (pixel ids
              in, film out): the same three scenes through a small camera.
              Each of these once more on the same media built with
              pack=False (the dense instantiations of both kernels, reading
              the grids' own arrays), against the plain version and against
              the packed kernel's result
  4. flagship the main path, Scene.from_config -> render -> film_to_srgb_u8
              -> write_png, on the flagship configuration (wdas_cloud
              transport, fog_sphere(30, 6) = 77^3, 256x256 at 16 waves);
              rays/s, launch counts, n_capped, finiteness. Then one wave by
              each kernel against its plain version, a chunked and a
              repeated wave bitwise, the kernels' device times, bounds, SIMT
              efficiency and idle tail, the device time against max_steps,
              the ray-batch path (render_rays_wave, which goes through
              trace_lanes), and a profile of one pass. Then the unpacked
              flagship medium: one whole wave by each dense kernel against its plain
              version and the packed kernel, the dense kernels' lines, the
              dense and packed wave side by side (time, distinct sectors and
              rows read, SIMT efficiency, idle tail), the ray-batch path;
              and the unpacked main path
  5. fire     the same path on bench.py's fire cell (fire transport,
              fire_plume(96, 28), 256x256, 4 waves): the misaligned
              temperature grid (8-wide rows plus the temperature gather), the
              aligned one (16-wide rows) and the unpacked medium (the dense
              temperature array), with the kernel's lines, the 8-wide and
              the dense wave side by side
  6. 512^3    big_cloud(512) with its 4.3 GB fused table, 256x256, 2 waves;
              rays/s, peak device memory and the kernel's lines (the
              generated grid is cached in chip_smoke_out/ for later runs).
              The same grid written to .nvdb and read back, C++ core against
              numpy path (host seconds, file size), and rendered unpacked
              (0.54 GB on the card, a peak of at most 1.9 GB): one wave's
              dense film bitwise equal to the packed kernel's, and the two
              waves side by side
  7. cli      cli.main on scene files whose volume_path names a .nvdb written
              here (the flagship stand-in and the fire plume, 256x256): the
              medium read back and the film against the direct build; then
              the procedural plume, and once more with --profile
  9. train    the gradient path (after phase 8's summary lines): the record
              kernel (lanes born from the rays in the kernel) against
              trace_lanes_kernel fed torch's init_state on the flagship wave
              (packed and dense) and at
              voxel size 0.1: radiance and counters bitwise; on the three
              small scenes, with media rebuilt by medium_with_params, packed
              and dense, k_walks 16 and 0, the replay kernel's
              gradient grids (longest-first order) against the plain
              replay; loss_rays_kernel (the train step's ray batch)
              against its plain version, ids, words and jitter bitwise, on
              the density step's inputs and at the benchmark's 256x256 x 4,
              with its time and bound; the full 131,072-lane density
              step: both kernels
              against their plain versions, the accounting invariant on
              every lane, each lane's replayed <g, L> bitwise with and
              without the order, and step 0's lines for both kernels (time,
              lane-steps, SIMT efficiency, idle tail, resident blocks,
              registers and spills, bound; the replay in both orders); then
              bench.py's three train cells (density packed and unpacked,
              joint density and temperature) through make_train_step: train
              rays/s, the step's device time by kernel, host launches a
              step, busy share and peak memory
 10. mesh     the parallel/ layer (prints torch.cuda.device_count()): the
              flagship (256x256, 16 waves) by render_film_sharded on meshes
              4x1 and 2x2 over the one card (over the cards where there
              are several; on one card a mesh measures correctness and
              overhead, not scaling): 'rays' bitwise the one-device render,
              'spp' within 2e-5 of sequential waves, lane-iterations equal
              to one device's, rays/s beside the one-device render; the
              unpacked flagship on 4x1 (dense launches per launch as on one
              device); the density train cell (128x128 x
              8) through make_train_step on 2x1 against mesh=None (loss
              rtol 1e-5, gradients rtol 1e-4, atol 1e-6); the
              multi-process example at its defaults (1024x1024, 8 waves)
              over NCCL at world size 1 and in two processes on the one
              card over gloo (films bitwise equal, rays/s); the
              inverse-rendering example at its defaults, density and
              --joint (train steps/s, recovery)
 11. bench    the port's bench (python -m volume_path_tracer_tpu_torch.bench):
              its primary at bench.py's full size (flagship, 256x256, 16
              waves, best of 5 passes) through render_wave_kernel alone, its
              film bitwise render's and its rays/s within BENCH_RTOL of
              phase 4's render part; its JSON line; then the flagship half
              of its --verify (the plain version against the kernel, every
              gate)

The line before the last is the kernels' JSON record (launches on the main
path, launches_bench in the bench's primary, error against the plain
version, times and bound); the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX. Images and the CLI's
scene file go to chip_smoke_out/ (listed in .gitignore).

Other modes: --phase 9, --phase 10, --phase 11 (phases 1, 2 and that one
alone, no result lines);
--compare [DIR] (the port in the checkout DIR with its own code: the wave
cells packed and dense, the gradient kernels and the three train cells, so
that a parent commit unpacked with git archive and this one compare on one
machine, in turns, see compare()); --variants (variants of the kernel
source timed in turns in one process on the same media, see variants()).
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
# gather point, trilinear weights and dot, segment derivation, event), and
# per camera ray made by render_wave_kernel (jitter, ray, box clip).
OPS_PER_LANE_STEP = 150
OPS_PER_RAY_SETUP = 80
# The counting wave kernel's lane-iterations against the plain version's on
# the same inputs: equal but for the lanes whose knife-edge events flip
# (trace_statistic) and then take other paths.
LANE_ITERS_RTOL = 0.01

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
HD_SCENE = dict(WDAS_SCENE, output_size=[1920, 1080], num_waves=1)

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


T_START = time.perf_counter()


def phase(name):
    print(f"== {name}  (at {time.perf_counter() - T_START:.1f} s)", flush=True)


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


# CUPTI windows each kernel_device_ms call takes, and the share of the
# median kernel record below which a record is dropped.
WINDOWS = 3
LOW_RECORD = 0.7
RECORD_COUNTS = {"taken": 0, "dropped": 0}


def kernel_device_ms(fn, reps, kernel_name):
    """Device milliseconds of one launch of the kernels named `kernel_name`,
    from CUPTI kernel records (no wrapper work, no host time): the mean of
    the records kept from `reps` calls of fn() in each of WINDOWS profiler
    windows. CUPTI now and then drops records of a window's launches: a
    window that kept fewer than half of its records is taken again (at most
    2 * WINDOWS windows in all). It also now and then reports launches at
    about half their time, often most of one window's (seen on the H100,
    cause unknown): a record under LOW_RECORD times the median of the call's
    records is dropped, and counted in RECORD_COUNTS. Prints each window's
    mean of all its records and the records dropped."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    windows = []
    for _ in range(2 * WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        recs = [e.device_time_total / 1e3 for e in prof.events()
                if e.device_type == DeviceType.CUDA and kernel_name in e.name]
        if reps // 2 <= len(recs) <= reps:
            windows.append(recs)
        if len(windows) == WINDOWS:
            break
    check(len(windows) >= 2, f"the profiler kept too few records of {kernel_name} in {2 * WINDOWS} windows")
    recs = [r for w in windows for r in w]
    floor = LOW_RECORD * statistics.median(recs)
    kept = [r for r in recs if r >= floor]
    RECORD_COUNTS["taken"] += len(recs)
    RECORD_COUNTS["dropped"] += len(recs) - len(kept)
    print(f"  CUPTI windows of {kernel_name}: {'/'.join(f'{sum(w) / len(w):.4f}' for w in windows)} ms, "
          f"records dropped {len(recs) - len(kept)} of {len(recs)}")
    return sum(kept) / len(kept)


def record_summary():
    print(f"CUPTI kernel records: {RECORD_COUNTS['taken']} taken, {RECORD_COUNTS['dropped']} dropped as under "
          f"{LOW_RECORD} of their call's median")


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
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"big_cloud_{n}-{tag}.npy")
    if os.path.exists(path):
        h = n // 2
        return dense_grid_from_array(np.load(path), origin_ijk=(-h, -h, -h), voxel_size=1.0), True
    grid = procedural.big_cloud(n=n)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, grid.data)
    os.replace(tmp, path)
    return grid, False


def film_statistic(film_k, nc_k, film_p, nc_p, what):
    """Hold a film the wave kernel made from zero to the plain version's:
    weights exactly 1 on both, radiance by trace_statistic."""
    k = film_k.reshape(-1, 4).cpu().numpy()
    p = film_p.reshape(-1, 4).cpu().numpy()
    check(bool((k[:, 3] == p[:, 3]).all()), f"{what}: sample counts differ")
    trace_statistic(k[:, :3], nc_k, p[:, :3], nc_p, what)


def lane_iters_check(mk, film_k, wave, li_p, what):
    """Launch the counting wave kernel (render_wave with
    return_lane_iters) on `wave`, the arguments the wave kernel made film_k
    with from zero: its film must be film_k bitwise and its lane-iterations
    the plain version's li_p within LANE_ITERS_RTOL. Returns the kernel's."""
    import torch

    film_c = torch.zeros_like(film_k)
    li_k = int(mk.render_wave(film=film_c, **wave, return_lane_iters=True)[2])
    li_p = int(li_p)
    same = bool(torch.equal(film_c, film_k))
    print(f"counting wave {what}: film bitwise equal to the wave kernel's {same}; lane-iterations {li_k} "
          f"against the plain version's {li_p} (rel diff {abs(li_k - li_p) / max(li_p, 1):.3e})")
    check(same, f"{what}: the counting wave kernel's film differs from the wave kernel's")
    check(abs(li_k - li_p) <= LANE_ITERS_RTOL * li_p,
          f"{what}: lane-iterations {li_k} against the plain version's {li_p} beyond rtol {LANE_ITERS_RTOL}")
    return li_k


def wave_args(scene, wave):
    from volume_path_tracer_tpu_torch.utils import rng as vrng

    return dict(medium=scene.medium, params=scene.params, camera=scene.camera,
                bb_table=scene.bb_table, stream=vrng.mix_stream(scene.seed, wave),
                use_jitter=scene.use_jitter, imaging_ratio=scene.camera.imaging_ratio)


def tap_bytes(medium, params, bb_table, tap):
    """(bytes, words) of what a measuring launch marked in `tap`: every
    distinct table row, or for an unpacked medium every distinct 32-byte
    sector of the density and temperature arrays and every majorant pair."""
    from volume_path_tracer_tpu_torch.render import megakernel as mk

    marks = mk.read_row_tap(medium, params, bb_table, tap)
    return sum(b for *_, b in marks), ", ".join(f"{hit} of {n} {what}" for what, hit, n, _ in marks)


def wave_kernel_report(scene, what, card):
    """render_wave_kernel on wave 1 of `scene`, alone: device time (CUPTI,
    kernel_device_ms of 10), and from one measuring launch the lane-steps, what it read
    of the medium, SIMT efficiency as issued and the idle tail. The bound
    counts each byte once: 16 B of film read and 16 B written per pixel and
    every distinct table row (unpacked: density and temperature sectors and
    majorant pairs); operations: the lane-steps taken plus the ray set-up."""
    import torch

    from volume_path_tracer_tpu_torch.render import megakernel as mk

    dev = scene.device
    H, W = scene.height, scene.width
    n = W * H
    kw = wave_args(scene, 1)
    film = torch.zeros((H, W, 4), dtype=torch.float32, device=dev)
    ms = kernel_device_ms(lambda: mk.render_wave(film=film, pixels=range(0, n), **kw), 10,
                          "render_wave_kernel")
    tap = mk.new_row_tap(scene.medium, scene.params, scene.bb_table)
    stat = mk.launch_stat(dev)
    iters, ncap = mk.render_wave(film=film, pixels=range(0, n), row_tap=tap, stat=stat, **kw)
    torch.cuda.synchronize()
    st = mk.read_launch_stat(stat)
    row_bytes, read_words = tap_bytes(scene.medium, scene.params, scene.bb_table, tap)
    bytes_moved = n * 32 + row_bytes
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops = st["lane_steps"] * OPS_PER_LANE_STEP + n * OPS_PER_RAY_SETUP
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"render_wave {what} ({n} pixels, one wave): kernel {ms:.4f} ms (device time, mean of the kept records of 3 windows of 10 launches); "
          f"lane-steps {st['lane_steps']} (longest lane {int(iters)}, n_capped {int(ncap)}); read "
          f"{read_words}; bound {bound_ms:.5f} ms ({by}: {bytes_moved} B = {n * 32} B film + {row_bytes} B "
          f"of the medium, "
          f"{bytes_ms:.5f} ms; {ops} fp32 ops, {ops_ms:.5f} ms) = {bound_ms / ms:.4f} of the kernel's time; "
          f"SIMT efficiency as issued {st['simt_efficiency']:.4f} ({st['warp_steps']} warp-steps on "
          f"{st['warps']} warps); under half of the warps at work for {st['half_idle_share']:.3f} of the "
          f"measuring launch ({st['span_ns'] / 1e6:.4f} ms on the device timer) on {card}")
    return dict(ms=ms, bound_ms=bound_ms, bound_by=by, read=read_words, **st)


def dense_beside_packed(packed, dense, what, card):
    """The packed and the dense wave kernel on the same wave, side by side
    (two wave_kernel_report results): the lanes take the same paths, so
    whatever differs is the fetch."""
    print(f"{what} wave, packed | dense kernel: {packed['ms']:.4f} | {dense['ms']:.4f} ms (dense / packed "
          f"{dense['ms'] / packed['ms']:.3f}); lane-steps {packed['lane_steps']} | {dense['lane_steps']}; read "
          f"{packed['read']} | {dense['read']}; SIMT efficiency as issued {packed['simt_efficiency']:.4f} | "
          f"{dense['simt_efficiency']:.4f}; under half of the warps at work for {packed['half_idle_share']:.3f} | "
          f"{dense['half_idle_share']:.3f} of the measuring launch on {card}")


def crop_to_active(grid):
    """(data, origin_ijk) of a grid cut to the bounding box of its nonzero
    voxels: what a .nvdb reader returns for it."""
    import numpy as np

    data = grid.data.cpu().numpy()
    nz = np.nonzero(data)
    lo = [int(a.min()) for a in nz]
    hi = [int(a.max()) + 1 for a in nz]
    cut = np.ascontiguousarray(data[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]])
    return cut, tuple(o + l for o, l in zip(grid.origin_ijk, lo))


def reset_launch_counts(mk):
    mk.WAVE_LAUNCHES = mk.LAUNCHES = mk.PLAIN_WAVE_LAUNCHES = mk.PLAIN_LAUNCHES = 0
    mk.DENSE_WAVE_LAUNCHES = mk.DENSE_LAUNCHES = 0
    mk.RECORD_LAUNCHES = mk.REPLAY_LAUNCHES = mk.PLAIN_RECORD_LAUNCHES = mk.PLAIN_REPLAY_LAUNCHES = 0
    mk.DENSE_RECORD_LAUNCHES = mk.DENSE_REPLAY_LAUNCHES = 0
    mk.LOSS_RAYS_LAUNCHES = mk.PLAIN_LOSS_RAYS_LAUNCHES = 0


def profile_pass(scene, png_path, best_s, what):
    """Where one pass of the main path spends its time (torch.profiler,
    CUPTI): device time summed over the kernels alone (a PyTorch op's own
    entry repeats its kernels' time, so only device events count), the wave
    kernel's share, the device busy share, and host calls per wave."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, (render_s,), _, _ = render_passes(scene, 1, png_path)
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev)
    kern_us = sum(e.self_device_time_total for e in dev if "render_wave_kernel" in e.key)
    check(kern_us > 0, f"{what}: the profiler saw no render_wave_kernel device time")

    def calls(*keys):
        return sum(e.count for e in ka if e.key in keys)

    waves = scene.num_waves
    print(f"profile of one {what} pass: device time {dev_us / 1e3:.3f} ms (render_wave_kernel "
          f"{kern_us / 1e3:.3f} ms = {kern_us / dev_us:.3f} of it, {kern_us / 1e3 / waves:.4f} ms a wave), "
          f"device busy share {dev_us / 1e6 / wall:.3f} of the profiled {wall * 1e3:.1f} ms "
          f"({kern_us / 1e6 / render_s:.3f} of its {render_s * 1e3:.1f} ms of render by the wave kernel "
          f"alone) and {dev_us / 1e6 / best_s:.3f} of the best unprofiled pass; per wave: "
          f"{calls('cudaLaunchKernel', 'cudaLaunchKernelExC') / waves:.1f} kernel launches, "
          f"{calls('cudaStreamSynchronize', 'cudaDeviceSynchronize') / waves:.1f} syncs, "
          f"{calls('cudaMemcpyAsync') / waves:.1f} copies, {calls('cudaMemsetAsync') / waves:.1f} memsets")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:70]}")


def render_passes(scene, reps, png_path):
    """Time `reps` full passes of the main path (render -> tonemap -> PNG).
    Returns the passes' seconds, and of each the seconds until the film was
    rendered (a sync after render), the last film and image."""
    import torch

    from volume_path_tracer_tpu_torch.io.png import write_png
    from volume_path_tracer_tpu_torch.render.renderer import render
    from volume_path_tracer_tpu_torch.utils.color import film_to_srgb_u8

    times, render_times, film = [], [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = render(scene)
        torch.cuda.synchronize()
        render_times.append(time.perf_counter() - t0)
        img = film_to_srgb_u8(film).cpu().numpy()
        write_png(png_path, img)
        times.append(time.perf_counter() - t0)
    return times, render_times, film, img


def main_path(scene, passes, png_path, what, card):
    """Drive the main path `passes` times with every launch counter set to 0
    just before and read just after; check that it went through the wave
    kernel alone, and that the film is finite with weights == waves. Returns
    (pass seconds, rays/s, n_capped, launches, render-part rays/s)."""
    import torch

    from volume_path_tracer_tpu_torch.render import megakernel as mk
    from volume_path_tracer_tpu_torch.render.renderer import render_wave_image

    reset_launch_counts(mk)
    times, render_times, film, img = render_passes(scene, passes, png_path)
    render_rays_s = scene.width * scene.height * scene.num_waves / min(render_times)
    counts = dict(render_wave=mk.WAVE_LAUNCHES, trace_lanes=mk.LAUNCHES,
                  render_wave_plain=mk.PLAIN_WAVE_LAUNCHES, trace_lanes_plain=mk.PLAIN_LAUNCHES,
                  render_wave_dense=mk.DENSE_WAVE_LAUNCHES)
    waves = scene.num_waves
    rays_s = scene.width * scene.height * waves / min(times)
    ncap = sum(int(render_wave_image(scene, w, return_ncap=True)[1]) for w in range(1, waves + 1))
    finite = bool(torch.isfinite(film).all())
    weights_ok = bool((film[..., 3] == waves).all())
    print(f"{what} {scene.width}x{scene.height}x{waves}: rays/s {rays_s:.1f} (best of {passes}; pass seconds "
          f"{[round(t, 4) for t in times]}, of which render {[round(t, 4) for t in render_times]}, the "
          f"rest tonemap and PNG); launches in {passes} passes {json.dumps(counts)} = "
          f"{counts['render_wave'] / (passes * waves):.2f} render_wave launches a wave; n_capped ({waves} "
          f"waves, max_iters {scene.params.max_iters}) {ncap}, film finite {finite}, weights == waves "
          f"{weights_ok}, image mean {img.mean():.2f} on {card}")
    check(counts["render_wave"] > 0, f"{what}: the main path never launched the wave kernel")
    dense_want = counts["render_wave"] if scene.medium.density_rows is None else 0
    check(counts["render_wave_dense"] == dense_want,
          f"{what}: {counts['render_wave_dense']} dense launches, expected {dense_want}")
    check(counts["render_wave_plain"] == 0 and counts["trace_lanes_plain"] == 0,
          f"{what}: the main path ran a plain version")
    check(finite and weights_ok, f"{what}: film is not finite or has wrong weights")
    check(img.max() > 0, f"{what}: image is black")
    return times, rays_s, ncap, counts, render_rays_s


# bench.py's train cells (bench.py:287-304, :336-352), rebuilt on the port:
# 128x128 pixels, 8 samples a step (131,072 lanes), 1024 steps a lane,
# chains of 4 device-resident steps, best of 3 chains.
TRAIN_SIZE = 128
TRAIN_K = 8
TRAIN_ITERS = 1024
TRAIN_CHAIN = 4
# Float operations per replay lane-step, counted from replay_step in
# csrc/trace_lanes.cu beside OPS_PER_LANE_STEP's traversal: the suffix and
# score weight, ratio tracking, the 8 corner weights times the event weight.
OPS_PER_REPLAY_STEP = 200
# Lanes of each small gradient case (phase 9 (b)).
SMALL_LANES = 2048


def rel_l2(a, b):
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def device_split(prof, wall_s):
    """(record ms, replay ms, other kernels ms, device busy share, the
    device events) from a profile: CUPTI kernel records only, without the
    device-side ranges of user annotations (Optimizer.step's would count
    its kernels twice)."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in dev)
    rec = sum(e.self_device_time_total for e in dev if "trace_lanes_kernel" in e.key and "true>" in e.key)
    rep = sum(e.self_device_time_total for e in dev if "replay_lanes_kernel" in e.key)
    return rec / 1e3, rep / 1e3, (total - rec - rep) / 1e3, total / 1e6 / wall_s, dev


def host_calls(prof):
    """(kernel launches, memsets, copies, syncs) the host issued in a
    profile, from its CUDA runtime records."""
    ka = prof.key_averages()

    def calls(*keys):
        return sum(e.count for e in ka if e.key in keys)

    return (calls("cudaLaunchKernel", "cudaLaunchKernelExC"), calls("cudaMemsetAsync"),
            calls("cudaMemcpyAsync"), calls("cudaStreamSynchronize", "cudaDeviceSynchronize"))


def ptxas_report(log_text):
    """{kernel instantiation: (registers, spill store bytes, spill load
    bytes)} from nvcc's -Xptxas -v report, with template arguments written
    out (trace_lanes_kernel<false, 1, true>: kTap, kDense, kRecord)."""
    import re

    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"(render_wave_kernel|trace_lanes_kernel|replay_lanes_kernel)", mangled)
            args = re.findall(r"L([bi])(\d+)E", mangled)
            name = (base.group(1) if base else mangled) + "<" + ", ".join(
                ("true" if v == "1" else "false") if t == "b" else v for t, v in args) + ">"
            out[name] = [0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def density_step(dev):
    """bench.py's density train cell, first step: (packed medium, base
    medium, params, camera, raster, pixel ids, the step's rays (o_w, d_w,
    pids_k, stream_k))."""
    import torch

    from volume_path_tracer_tpu_torch.diff import inverse as inv
    from volume_path_tracer_tpu_torch.grids.procedural import fog_sphere
    from volume_path_tracer_tpu_torch.models.camera import Camera
    from volume_path_tracer_tpu_torch.models.medium import Medium
    from volume_path_tracer_tpu_torch.render import integrator as integ
    from volume_path_tracer_tpu_torch.render.renderer import pixel_coords
    from volume_path_tracer_tpu_torch.utils.config import CameraParameters

    coords = torch.from_numpy(pixel_coords(TRAIN_SIZE, TRAIN_SIZE)).to(dev)
    tpids = torch.arange(TRAIN_SIZE * TRAIN_SIZE, dtype=torch.int32, device=dev)
    wdas = integ.IntegratorParams(**dict(FOG_PARAMS, max_iters=TRAIN_ITERS))
    fog_cam = Camera.from_parameters(
        CameraParameters((110.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 35.0, 0.1),
        (TRAIN_SIZE, TRAIN_SIZE), device=dev)
    fog_base = Medium.from_grids(fog_sphere(radius=30.0, falloff=6.0), pack=False)
    med = inv.medium_with_params(fog_base, inv.OptimizableGrids(inv.param_from_density(fog_base.density.data)),
                                 pack=True)
    rays = inv.loss_rays(fog_cam, coords, tpids, (3, 1), TRAIN_K, True)
    return med, fog_base, wdas, fog_cam, coords, tpids, rays


def loss_rays_report(card, dev, camera, raster, pids, seed_wave, k, what):
    """loss_rays_kernel (megakernel.loss_rays on CUDA tensors) against
    loss_rays_plain on the same card inputs: pixel ids, stream words and the
    jitter uniforms bitwise, origins equal, directions within 1e-6 (the
    product's rounding order differs); one kernel launch a call and no plain
    run. Then its device time (CUPTI, kernel_device_ms of 20), the plain
    version's (host clock, mean of 5 calls after one) and its bound, each
    byte once: raster and id a pixel and the camera's 48 B read, direction,
    id and word a lane written, over HBM_BYTES_PER_S. Prints the line and
    returns (max_abs_err, ms, plain_ms, bound_ms)."""
    import torch

    from volume_path_tracer_tpu_torch.render import megakernel as mk
    from volume_path_tracer_tpu_torch.utils import rng as vrng

    n = pids.shape[0]
    lanes = k * n
    jit = torch.full((lanes, 2), -1.0, dtype=torch.float32, device=dev)
    counts = (mk.LOSS_RAYS_LAUNCHES, mk.PLAIN_LOSS_RAYS_LAUNCHES)
    o, d, p, s = mk.loss_rays(camera, raster, pids, seed_wave, k, True, jitter_out=jit)
    counts = (mk.LOSS_RAYS_LAUNCHES - counts[0], mk.PLAIN_LOSS_RAYS_LAUNCHES - counts[1])
    ro, rd, rp, rs = mk.loss_rays_plain(camera, raster, pids, seed_wave, k, True)
    u = vrng.counter_uniforms(rp, rs, mk.JITTER_COUNTER, 2)
    same = dict(ids=bool(p.dtype == rp.dtype and torch.equal(p, rp)),
                words=bool(s.dtype == torch.int32 and torch.equal(s.to(torch.int64) & 0xFFFFFFFF, rs)),
                jitter=bool(torch.equal(jit.view(torch.int32), u.view(torch.int32))),
                origins=bool(o.stride(0) == 0 and torch.equal(o, ro)))
    err = float((d - rd).abs().max())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        mk.loss_rays_plain(camera, raster, pids, seed_wave, k, True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / 5
    ms = kernel_device_ms(lambda: mk.loss_rays(camera, raster, pids, seed_wave, k, True), 20, "loss_rays_kernel")
    read = n * (2 * raster.element_size() + pids.element_size()) + 48
    written = lanes * (12 + pids.element_size() + 4)
    bound_ms = (read + written) / HBM_BYTES_PER_S * 1e3
    print(f"loss_rays kernel, {what} ({n} pixels x {k} = {lanes} lanes, seed-wave {tuple(seed_wave)}, {raster.dtype} "
          f"raster, {pids.dtype} ids): bitwise equal to the plain version's {same}; directions max abs diff "
          f"{err:.3e}; launches {counts[0]}, plain runs {counts[1]}; {ms:.5f} ms (device time, mean of the kept "
          f"records of 3 windows of 20 launches); plain version {plain_ms:.3f} ms (host clock); bound {bound_ms:.5f} "
          f"ms (bytes: {read} B read, {written} B written) = {bound_ms / ms:.4f} of the kernel's time on {card}",
          flush=True)
    check(all(same.values()), f"loss_rays kernel, {what}: not bitwise the plain version's: {same}")
    check(err <= 1e-6, f"loss_rays kernel, {what}: directions {err} from the plain version's, beyond 1e-6")
    check(counts == (1, 0), f"loss_rays kernel, {what}: {counts[0]} launches and {counts[1]} plain runs in one call")
    return err, ms, plain_ms, bound_ms


def grad_kernel_times(mk, med, wdas, rays, g, reps=5):
    """(record ms, replay ms) on the density step, CUPTI, mean of `reps`
    each; the replay in the longest-first order, as on the main path."""
    import torch

    K = 16
    ray_args = (med, wdas, None, *rays)
    L, tf, ctr = mk.record_lanes(*ray_args, K)
    order = mk.longest_first(ctr)
    torch.cuda.synchronize()
    rec_ms = kernel_device_ms(lambda: mk.record_lanes(*ray_args, K), reps, "trace_lanes_kernel")
    rep_ms = kernel_device_ms(lambda: mk.replay_lanes(*ray_args, L, g, tf=tf, order=order), reps,
                              "replay_lanes_kernel")
    return rec_ms, rep_ms


def train_cells(card, dev, fog_base, wdas, fog_cam, coords, tpids):
    """bench.py's three train cells through make_train_step: train rays/s
    (best of 3 chains of TRAIN_CHAIN steps), launches, peak memory, and one
    profiled step (device time by kernel, busy share, host calls). Uses only
    what every commit of the port since the gradient path has, so an earlier
    commit's package can be timed by the same code (--compare); the ray
    batch's launches are checked where the package has loss_rays_kernel
    (megakernel.loss_rays). Returns ({"record": launches, "replay":
    launches, "loss_rays": launches}, {cell: summary})."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from volume_path_tracer_tpu_torch.diff import inverse as inv
    from volume_path_tracer_tpu_torch.diff import prb
    from volume_path_tracer_tpu_torch.grids.procedural import fire_plume
    from volume_path_tracer_tpu_torch.models.camera import Camera
    from volume_path_tracer_tpu_torch.models.medium import Medium
    from volume_path_tracer_tpu_torch.render import integrator as integ
    from volume_path_tracer_tpu_torch.render import megakernel as mk
    from volume_path_tracer_tpu_torch.utils.config import CameraParameters
    from volume_path_tracer_tpu_torch.utils.spectral import blackbody_xyz_table

    bb = torch.from_numpy(blackbody_xyz_table()).to(dev)
    fire_dens, fire_temp = fire_plume(height=96, radius=28.0)
    joint_base = Medium.from_grids(fire_dens, fire_temp, pack=False)
    fire_cam = Camera.from_parameters(
        CameraParameters((170.0, 48.0, 0.0), (0.0, 48.0, 0.0), (0.0, 1.0, 0.0), 37.0, 0.1),
        (TRAIN_SIZE, TRAIN_SIZE), device=dev)
    joint_params = integ.IntegratorParams(**dict(FIRE_PARAMS, max_depth=10_000, max_iters=TRAIN_ITERS))
    cells = [
        ("density packed", fog_base, wdas, fog_cam, None, True, False, 3),
        ("density unpacked", fog_base, wdas, fog_cam, None, False, False, 3),
        ("joint density + temperature", joint_base, joint_params, fire_cam, bb, True, True, 5),
    ]
    target = torch.zeros((TRAIN_SIZE * TRAIN_SIZE, 3), dtype=torch.float32, device=dev)
    launches = {"record": 0, "replay": 0, "loss_rays": 0}
    has_loss_rays = hasattr(mk, "loss_rays")
    summary = {}
    for label, base, prm, cam, bbt, pack, dual, seed in cells:
        grids = inv.OptimizableGrids(
            inv.param_from_density(base.density.data).clone().requires_grad_(True),
            base.temperature.data.clone().requires_grad_(True) if dual else None)
        opt = inv.make_optimizer(grids)
        step = inv.make_train_step(base, prm, cam, bbt, n_iters=TRAIN_ITERS, samples_per_step=TRAIN_K, pack=pack,
                                   dual_buffer=dual)
        batch = (coords, tpids, target)
        grids, opt, loss = step(grids, opt, *batch, (seed, 1))  # warm-up: first-call allocations
        float(loss)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts(mk)
        graph = getattr(step, "graph", None)  # the step's CUDA graph, where the package has one
        graph_counts = (graph.captures, graph.replays) if graph is not None else (0, 0)
        chains, losses = [], []
        for rep in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(TRAIN_CHAIN):
                grids, opt, loss = step(grids, opt, *batch, (seed, 2 + rep * TRAIN_CHAIN + i))
            losses.append(float(loss))  # the chain's one wait
            chains.append(time.perf_counter() - t0)
        counts = (mk.RECORD_LAUNCHES, mk.REPLAY_LAUNCHES, mk.PLAIN_RECORD_LAUNCHES, mk.PLAIN_REPLAY_LAUNCHES,
                  mk.DENSE_RECORD_LAUNCHES, mk.DENSE_REPLAY_LAUNCHES, mk.LAUNCHES, mk.WAVE_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        n_steps = 3 * TRAIN_CHAIN
        # The host runs a step's body (and so its launches) where the step is
        # eager or captured; a replayed step launches its graph alone.
        captured, replayed = ((graph.captures - graph_counts[0], graph.replays - graph_counts[1])
                              if graph is not None else (0, 0))
        bodies = n_steps - replayed + captured
        check(counts[0] == bodies and counts[1] == bodies,
              f"{label}: {counts[0]} record and {counts[1]} replay launches in {n_steps} steps "
              f"({replayed} replayed, {captured} captured)")
        check(counts[2] == 0 and counts[3] == 0, f"{label}: the train step ran a plain version")
        dense_want = 0 if pack else bodies
        check(counts[4] == dense_want and counts[5] == dense_want,
              f"{label}: {counts[4]} / {counts[5]} dense launches, expected {dense_want}")
        if has_loss_rays:
            check(mk.LOSS_RAYS_LAUNCHES == bodies and mk.PLAIN_LOSS_RAYS_LAUNCHES == 0,
                  f"{label}: {mk.LOSS_RAYS_LAUNCHES} loss_rays_kernel launches and {mk.PLAIN_LOSS_RAYS_LAUNCHES} "
                  f"plain ray batches in {n_steps} steps")
        check(pack or graph is None or (replayed, captured) == (n_steps, 1),
              f"{label}: {replayed} of {n_steps} steps replayed its CUDA graph, {captured} captures")
        launches["record"] += counts[0]
        launches["replay"] += counts[1]
        launches["loss_rays"] += mk.LOSS_RAYS_LAUNCHES
        finite = all(bool(torch.isfinite(x).all()) for x in inv.grid_leaves(grids))

        def grad_finite(x):
            if x.grad is not None:
                return bool(torch.isfinite(x.grad).all())
            # a replayed step's gradient lives in its graph: Adam's moments took it
            return all(bool(torch.isfinite(opt.state[x][k]).all()) for k in ("exp_avg", "exp_avg_sq"))

        grads_finite = all(grad_finite(x) for x in inv.grid_leaves(grids))
        check(all(np.isfinite(losses)) and finite and grads_finite, f"{label}: loss, grids or gradients not finite")
        best = min(chains)
        rays_s = TRAIN_SIZE * TRAIN_SIZE * TRAIN_K * TRAIN_CHAIN / best
        # One step profiled: device time by kernel (CUPTI records only) and
        # what the host issued.
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            grids, opt, loss = step(grids, opt, *batch, (seed, 100))
            float(loss)
            wall = time.perf_counter() - t0
        rec, rep, rest, busy, kern = device_split(prof, wall)
        n_launch, n_memset, n_copy, n_sync = host_calls(prof)
        top = sorted((e for e in kern if "lanes_kernel" not in e.key), key=lambda e: -e.self_device_time_total)[:3]
        host_top = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                          key=lambda e: -e.self_cpu_time_total)[:5]
        step_s = best / TRAIN_CHAIN
        # The host's share: the medium rebuilt (majorants, tables) and the
        # kernels' constants found for the new medium, timed alone.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m2 = inv.medium_with_params(base, grids, pack=pack)
        torch.cuda.synchronize()
        rebuild_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mk.kernel_constants(prb._detached_medium(m2), prm, bbt)
        torch.cuda.synchronize()
        consts_ms = (time.perf_counter() - t0) * 1e3
        print(f"train {label} ({TRAIN_SIZE}x{TRAIN_SIZE} x {TRAIN_K} samples = {TRAIN_SIZE * TRAIN_SIZE * TRAIN_K} "
              f"lanes a step, max_iters {TRAIN_ITERS}, {'packed' if pack else 'unpacked'}"
              f"{', dual buffer' if dual else ''}): train rays/s {rays_s:.1f} (best of 3 chains of {TRAIN_CHAIN} "
              f"steps, chain seconds {[round(c, 4) for c in chains]}); losses {[f'{x:.6g}' for x in losses]}; launches "
              f"in {n_steps} steps ({replayed} replayed as one CUDA graph, {captured} captured): record {counts[0]}, "
              f"replay {counts[1]}, plain 0, dense {counts[4]} / {counts[5]}; "
              f"peak device memory {peak / 1e9:.3f} GB; one profiled step {wall * 1e3:.2f} ms: device "
              f"{rec + rep + rest:.3f} ms = record kernel {rec:.3f} + replay kernel {rep:.3f} + the rest {rest:.3f} "
              f"(most: " + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f}" for e in top)
              + f"), device busy share {busy:.3f} of the profiled step and {(rec + rep + rest) / 1e3 / step_s:.3f} of "
              f"the best chain's {step_s * 1e3:.3f} ms a step; host: {n_launch} kernel launches, {n_memset} memsets, "
              f"{n_copy} copies, {n_sync} syncs in the step; most self time: "
              + ", ".join(f"{e.key[:32]} {e.self_cpu_time_total / 1e3:.2f} ms ({e.count}x)" for e in host_top)
              + f"; medium rebuild {rebuild_ms:.2f} ms, kernel constants {consts_ms:.2f} ms (host clock) on {card}",
              flush=True)
        summary[label] = dict(rays_s=rays_s, step_ms=step_s * 1e3, device_ms=rec + rep + rest, record_ms=rec,
                              replay_ms=rep, rest_ms=rest, busy=busy, launches=n_launch, peak_gb=peak / 1e9,
                              constants_ms=consts_ms)
        del grids, opt, step, m2
    print("train rays/s: " + json.dumps({k: round(v["rays_s"], 1) for k, v in summary.items()}) + f" on {card}")
    return launches, summary


def measuring_launch(mk, medium, params, dev, launch, bb_table=None):
    """launch(row_tap, stat) once with a fresh tap and stat; returns
    (read_launch_stat, the tap)."""
    import torch

    tap = mk.new_row_tap(medium, params, bb_table)
    stat = mk.launch_stat(dev)
    launch(tap, stat)
    torch.cuda.synchronize()
    return mk.read_launch_stat(stat), tap


def train_phase(card, dev):
    """Phase 9 on the CUDA device `dev`; returns the record, replay and
    ray-batch kernels' entries of the kernels line."""
    import numpy as np
    import torch

    from volume_path_tracer_tpu_torch.diff import inverse as inv
    from volume_path_tracer_tpu_torch.diff import prb
    from volume_path_tracer_tpu_torch.grids.grid import dense_grid_from_array
    from volume_path_tracer_tpu_torch.grids.procedural import fire_plume, fog_sphere
    from volume_path_tracer_tpu_torch.models.camera import Camera
    from volume_path_tracer_tpu_torch.models.medium import Medium
    from volume_path_tracer_tpu_torch.render import integrator as integ
    from volume_path_tracer_tpu_torch.render import megakernel as mk
    from volume_path_tracer_tpu_torch.render.renderer import Scene, pixel_coords
    from volume_path_tracer_tpu_torch.utils import rng as vrng
    from volume_path_tracer_tpu_torch.utils.config import CameraParameters, loads_configuration
    from volume_path_tracer_tpu_torch.utils.spectral import blackbody_xyz_table

    K = prb.DEFAULT_K_WALKS

    # (a) the record kernel against trace_lanes_kernel on the flagship wave:
    # the same rays, the record's lanes born in the kernel, trace_lanes's
    # from torch's init_state: radiance and counters bitwise; packed and
    # dense
    flag_cfg = loads_configuration(json.dumps(WDAS_SCENE))
    for form in ("packed", "dense"):
        pack = form == "packed"
        med = Medium.from_grids(fog_sphere(radius=30.0, falloff=6.0), pack=pack)
        sc = Scene.from_config(flag_cfg, med, max_iters=FLAGSHIP_MAX_ITERS)
        W, H = sc.width, sc.height
        pids = torch.arange(W * H, dtype=torch.int32, device=dev)
        stream = vrng.mix_stream(sc.seed, 1)
        u_jit = vrng.counter_uniforms(pids, stream, mk.JITTER_COUNTER, 2)
        o_w, d_w = sc.camera.generate_rays(torch.from_numpy(pixel_coords(W, H)).to(dev), u_jit * 0.5)
        ray_args = (med, sc.params, None, o_w, d_w, pids, stream)
        sf0, si0 = mk.pack_state(integ.init_state(med, o_w, d_w, sc.params))
        sf_t, si_t = mk.trace_lanes(med, sc.params, None, sf0, si0, pids, integ.lane_streams(stream, W * H, dev),
                                    sc.params.max_iters)
        L_r, tf, ctr = mk.record_lanes(*ray_args, K)
        torch.cuda.synchronize()
        same = bool(torch.equal(L_r, sf_t[10:13].T))
        same_ctr = bool(torch.equal(ctr, si_t[2]))
        walks = int((tf != 0).sum())
        line = (f"record kernel, flagship wave ({W * H} lanes, {form}): radiance bitwise "
                f"equal to trace_lanes_kernel's {same}, counters bitwise equal {same_ctr}; {walks} walks recorded "
                f"in {K} slots a lane")
        if pack:
            rec_ms = kernel_device_ms(lambda: mk.record_lanes(*ray_args, K), 10, "trace_lanes_kernel")
            tl_ms = kernel_device_ms(lambda: mk.trace_rays_fused(*ray_args), 10, "trace_lanes_kernel")
            line += f"; record kernel {rec_ms:.4f} ms, trace_lanes_kernel {tl_ms:.4f} ms (device time, mean of the kept records of 3 windows of 10 launches)"
        print(line + f" on {card}", flush=True)
        check(same, f"the record kernel's flagship radiance differs from trace_lanes_kernel's ({form})")
        check(same_ctr, f"the record kernel's counters differ from trace_lanes_kernel's ({form})")
        check(walks > 0, "the record kernel recorded no walk on the flagship wave")
    del med, sc, L_r, tf, sf0, si0, sf_t, si_t
    # The same at a voxel size of 0.1, which is not a power of two: the
    # kernel's world -> index and init_state's (grids/grid.py) are both a
    # true division, so bitwise here too.
    v = 0.1
    med = Medium.from_grids(fog_sphere(radius=30.0, falloff=6.0, voxel_size=v), pack=True)
    rng = np.random.default_rng(4)
    n_v = 65536
    o_v = torch.tensor(np.stack([np.full(n_v, -50 * v), rng.uniform(-36 * v, 36 * v, n_v),
                                 rng.uniform(-36 * v, 36 * v, n_v)], -1), dtype=torch.float32, device=dev)
    aim = torch.tensor(rng.uniform(-20 * v, 20 * v, (n_v, 3)), dtype=torch.float32, device=dev)
    d_v = torch.nn.functional.normalize(aim - o_v, dim=-1)
    pids = torch.arange(n_v, dtype=torch.int32, device=dev)
    stream = vrng.mix_stream(5, 1)
    prm = integ.IntegratorParams(**FOG_PARAMS)
    sf0, si0 = mk.pack_state(integ.init_state(med, o_v, d_v, prm))
    sf_t, si_t = mk.trace_lanes(med, prm, None, sf0, si0, pids, integ.lane_streams(stream, n_v, dev),
                                prm.max_iters)
    L_r, _, ctr = mk.record_lanes(med, prm, None, o_v, d_v, pids, stream, K)
    L_t = sf_t[10:13].T
    bitwise = float((L_r == L_t).all(-1).float().mean())
    close = float(torch.isclose(L_r, L_t, rtol=1e-4, atol=1e-5).all(-1).float().mean())
    same_ctr = float((ctr == si_t[2]).float().mean())
    print(f"record kernel at voxel size {v} ({n_v} lanes, packed): lanes bitwise equal to trace_lanes_kernel's "
          f"{bitwise:.4f}, lane-close {close:.4f} (rtol 1e-4, atol 1e-5), counters equal {same_ctr:.4f}, "
          f"radiance relative L2 {rel_l2(L_r, L_t):.2e} on {card}", flush=True)
    check(bitwise == 1.0, f"voxel size {v}: record kernel and trace_lanes_kernel bitwise equal on {bitwise} of the lanes")
    check(same_ctr == 1.0, f"voxel size {v}: counters equal on {same_ctr} of the lanes")
    del med, o_v, d_v, aim, sf0, si0, sf_t, si_t, L_r, L_t, ctr

    # (b) the replay kernel (longest-first order, as on the main path)
    # against the plain replay: three small scenes through
    # medium_with_params, packed and dense, k_walks 16 and 0.
    dens, temp = fire_plume(height=40, radius=10.0)
    temp_al = dense_grid_from_array(temp.data, temp.origin_ijk, temp.voxel_size, (0.0, 0.0, 0.0))
    bb = torch.from_numpy(blackbody_xyz_table()).to(dev)
    cases = [
        ("fog_sphere", (fog_sphere(radius=12.0, falloff=3.0),), integ.IntegratorParams(**FOG_PARAMS), None,
         (-14, 14), (-14, 14)),
        ("fire_plume", (dens, temp), integ.IntegratorParams(**FIRE_PARAMS), bb, (5, 35), (-10, 10)),
        ("fire_plume_aligned", (dens, temp_al), integ.IntegratorParams(**FIRE_PARAMS), bb, (5, 35), (-10, 10)),
    ]
    N = SMALL_LANES
    worst, n_cases = 0.0, 0
    t_cases = time.perf_counter()
    for name, grids, prm, bbt, yr, zr in cases:
        rng = np.random.default_rng(0)
        o = torch.tensor(np.stack([np.full(N, -40.0), rng.uniform(*yr, N), rng.uniform(*zr, N)], -1),
                         dtype=torch.float32, device=dev)
        d = torch.tensor([[1.0, 0.0, 0.0]], device=dev).expand(N, 3).contiguous()
        lp = torch.arange(N, dtype=torch.int32, device=dev)
        s = vrng.mix_stream(3, 1)
        g_full = torch.tensor(np.random.default_rng(1).uniform(0.2, 1.0, (N, 3)), dtype=torch.float32, device=dev)
        base = Medium.from_grids(*grids, pack=False)
        og = inv.OptimizableGrids(inv.param_from_density(base.density.data),
                                  base.temperature.data if base.temperature is not None else None)
        for pack in (True, False):
            form = "packed" if pack else "dense"
            med = inv.medium_with_params(base, og, pack=pack)
            plain_args = (med, prm, bbt, o, d, lp, s)
            L_p, tf_p, ctr_p = mk.record_lanes_plain(*plain_args, K)
            L_k, tf_k, ctr_k = mk.record_lanes(*plain_args, K)
            agree = torch.isclose(L_k, L_p, rtol=1e-4, atol=1e-5).all(-1)
            check(float(agree.float().mean()) > 0.95,
                  f"{name} ({form}): record kernel and plain agree on {float(agree.float().mean())}")
            g = g_full * agree[:, None]
            for kw in (K, 0):
                gk = mk.replay_lanes(*plain_args, L_k, g, tf=tf_k if kw else None, order=mk.longest_first(ctr_k))
                gp = mk.replay_lanes_plain(*plain_args, L_p, g, tf=tf_p if kw else None)
                errs = []
                for what, a, b in (("density", gk[0], gp[0]), ("temperature", gk[1], gp[1])):
                    if b is None:
                        continue
                    check(float(b.abs().max()) > 0, f"{name}: zero plain {what} gradient")
                    errs.append((what, rel_l2(a, b)))
                worst = max([worst] + [e for _, e in errs])
                n_cases += 1
                print(f"replay kernel, {name} ({form}, k_walks {kw}, {N} lanes, "
                      f"{int(agree.sum())} with the cotangent): relative L2 against the plain replay "
                      + ", ".join(f"{w} {e:.2e}" for w, e in errs))
                for what, e in errs:
                    check(e <= 1e-3, f"{name} ({form}, k_walks {kw}): {what} gradient relative L2 {e} > 1e-3")
    print(f"replay kernel, {n_cases} small cases: worst relative L2 {worst:.2e} (bound 1e-3: float atomics add in "
          f"another order every run, FMA contraction); {time.perf_counter() - t_cases:.1f} s with the plain versions")

    # (c) the full density step: bench.py's density cell, first step. Its
    # ray batch first: loss_rays_kernel against the plain version on the
    # step's inputs, and at the benchmark's train shape (256x256 x 4, waves
    # wave0 * 4 + i past 2^32).
    med, fog_base, wdas, fog_cam, coords, tpids, rays = density_step(dev)
    lr_err, lr_ms, lr_plain_ms, lr_bound = loss_rays_report(card, dev, fog_cam, coords, tpids, (3, 1), TRAIN_K,
                                                            "density step")
    cam256 = Camera.from_parameters(
        CameraParameters((900.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 35.0, 1.0), (256, 256), device=dev)
    loss_rays_report(card, dev, cam256, torch.from_numpy(pixel_coords(256, 256)).to(dev),
                     torch.arange(256 * 256, dtype=torch.int32, device=dev), (0xDEADBEEF, 2**30 + 3), 4,
                     "the benchmark's train shape")
    del cam256
    o_w, d_w, pids_k, stream_k = rays
    n = pids_k.shape[0]
    ray_args = (med, wdas, None, *rays)
    L_k, tf_k, ctr_k = mk.record_lanes(*ray_args, K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L_p, tf_p, ctr_p = mk.record_lanes_plain(*ray_args, K)
    torch.cuda.synchronize()
    record_plain_ms = (time.perf_counter() - t0) * 1e3
    agree = torch.isclose(L_k, L_p, rtol=1e-4, atol=1e-5).all(-1)
    close = float(agree.float().mean())
    rel = ((L_k.mean(0) - L_p.mean(0)).abs() / (L_p.mean(0).abs() + 1e-9)).max()
    record_max_abs = float((L_k - L_p).abs().max())
    print(f"record kernel, density step ({n} lanes): lane-close {close:.4f} against the plain record, channel rel "
          f"diff {float(rel):.2e}, max_abs_err {record_max_abs:.3e} (on lanes where rounding flips an event); "
          f"counters equal to the plain loop's on {float((ctr_k == ctr_p).float().mean()):.4f} of the lanes")
    check(close > 0.95 and float(rel) < 0.05, f"density step: record kernel lane-close {close}, channel diff {rel}")
    order = mk.longest_first(ctr_k)
    g_full = torch.tensor(np.random.default_rng(2).uniform(0.2, 1.0, (n, 3)), dtype=torch.float32, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    grad_k, _, acc, tot = mk.replay_lanes(*ray_args, L_k, g_full, tf=tf_k, with_check=True, lane_steps=steps,
                                          order=order)
    steps_i = torch.zeros(n, dtype=torch.int32, device=dev)
    _, _, acc_i, _ = mk.replay_lanes(*ray_args, L_k, g_full, tf=tf_k, with_check=True, lane_steps=steps_i)
    torch.cuda.synchronize()
    bad = ~torch.isclose(acc, tot, rtol=1e-4, atol=1e-5)
    n_bad = int(bad.sum())
    worst_lanes = torch.nonzero(bad)[:8, 0].tolist()
    print(f"accounting invariant, density step ({n} lanes, k_walks {K}, longest group first): replayed <g, L> against "
          f"<g, L_fwd> at rtol 1e-4, atol 1e-5: {n - n_bad} lanes hold, {n_bad} miss"
          + (f" (lanes {worst_lanes}: {acc[worst_lanes].tolist()} against {tot[worst_lanes].tolist()})" if n_bad else "")
          + f"; max |acc - tot| {float((acc - tot).abs().max()):.3e}")
    check(n_bad == 0, f"the accounting invariant fails on {n_bad} lanes of the density step, e.g. {worst_lanes}")
    gacc_same = bool(torch.equal(acc, acc_i)) and bool(torch.equal(steps, steps_i))
    print(f"replay kernel, density step: each lane's replayed <g, L> and steps bitwise equal with the queue order "
          f"(longest group first) and in index order: {gacc_same}")
    check(gacc_same, "the queue order changed a lane's replay")
    g = g_full * agree[:, None]
    dk = mk.replay_lanes(*ray_args, L_k, g, tf=tf_k, order=order)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp = mk.replay_lanes_plain(*ray_args, L_p, g, tf=tf_p)[0]
    torch.cuda.synchronize()
    replay_plain_ms = (time.perf_counter() - t0) * 1e3
    replay_err = rel_l2(dk, dp)
    replay_max_abs = float((dk - dp).abs().max())
    print(f"replay kernel, density step ({int(agree.sum())} of {n} lanes with the cotangent): relative L2 "
          f"{replay_err:.2e}, max_abs_err {replay_max_abs:.3e} against the plain replay; plain versions: record "
          f"{record_plain_ms:.1f} ms, replay {replay_plain_ms:.1f} ms")
    check(replay_err <= 1e-3, f"density step: replay gradient relative L2 {replay_err} > 1e-3")

    # Step 0's lines: device time (CUPTI, kernel_device_ms of 5; the replay with the
    # order and without, in turns), and from one measuring launch each the
    # lane-steps, SIMT efficiency as issued, the idle tail and what it read;
    # resident blocks; registers and spills.
    occ, docc = mk.occupancy(dev), mk.occupancy(dev, dense=True)
    with open(mk.build() + ".log") as f:
        regs = ptxas_report(f.read())
    record_ms = kernel_device_ms(lambda: mk.record_lanes(*ray_args, K), 5, "trace_lanes_kernel")
    rec_st, rec_tap = measuring_launch(mk, med, wdas, dev,
                                       lambda tap, stat: mk.record_lanes(*ray_args, K, row_tap=tap, stat=stat))
    fwd_steps = int(ctr_k.to(torch.int64).sum())
    check(rec_st["lane_steps"] == fwd_steps, "the record kernel's step count differs from its counters' sum")
    turns = {"longest group first": [], "index order": []}
    for label in ("longest group first", "index order", "index order", "longest group first"):
        o_arg = order if label == "longest group first" else None
        turns[label].append(kernel_device_ms(lambda: mk.replay_lanes(*ray_args, L_k, g_full, tf=tf_k, order=o_arg),
                                             5, "replay_lanes_kernel"))
    rep_st = {}
    for label, o_arg in (("longest group first", order), ("index order", None)):
        rep_st[label] = measuring_launch(mk, med, wdas, dev, lambda tap, stat: mk.replay_lanes(
            *ray_args, L_k, g_full, tf=tf_k, order=o_arg, row_tap=tap, stat=stat))
    rep_steps = int(steps.to(torch.int64).sum())
    check(all(st["lane_steps"] == rep_steps for st, _ in rep_st.values()),
          "the replay kernel's step count differs from its lanes' steps")
    replay_ms = float(np.mean(turns["longest group first"]))
    replay_index_ms = float(np.mean(turns["index order"]))

    def regs_of(kernel):
        r = [regs.get(kernel.format(dense), (0, 0, 0)) for dense in (0, 1)]
        return f"{r[0][0]} / {r[1][0]} registers, spill stores {r[0][1]} / {r[1][1]} B (packed / dense)"

    def stat_words(st):
        return (f"SIMT efficiency as issued {st['simt_efficiency']:.4f} ({st['warp_steps']} warp-steps on "
                f"{st['warps']} warps); under half of the warps at work for {st['half_idle_share']:.3f} of the "
                f"measuring launch ({st['span_ns'] / 1e6:.4f} ms on the device timer)")

    # Bounds, each byte once: the record reads the rays (one origin for all:
    # 12 B), ids and streams and what its measuring launch marked of the
    # medium, and writes radiance, counter and residuals; the replay reads
    # the rays, ids, streams, the order, g, L and the residuals, what it
    # marked, and writes the distinct voxels of the gradient grid it touched
    # (4 B each: the kernel adds into the grid itself, no corner-row table).
    o_bytes = 12 if o_w.stride(0) == 0 else n * 12
    rec_rows, rec_words = tap_bytes(med, wdas, None, rec_tap)
    rec_bytes = o_bytes + n * (12 + 4 + 4 + 12 + 4 + 4 * K) + rec_rows
    rec_ops = fwd_steps * OPS_PER_LANE_STEP + n * OPS_PER_RAY_SETUP
    rec_b_ms, rec_o_ms = rec_bytes / HBM_BYTES_PER_S * 1e3, rec_ops / FP32_OPS_PER_S * 1e3
    rep_rows, rep_words = tap_bytes(med, wdas, None, rep_st["longest group first"][1])
    voxels_written = int((grad_k != 0).sum())
    rep_bytes = o_bytes + n * (12 + 4 + 4 + 4 + 12 + 12 + 4 * K) + rep_rows + voxels_written * 4
    rep_ops = rep_steps * OPS_PER_REPLAY_STEP + n * OPS_PER_RAY_SETUP
    rep_b_ms, rep_o_ms = rep_bytes / HBM_BYTES_PER_S * 1e3, rep_ops / FP32_OPS_PER_S * 1e3
    rec_bound, rep_bound = max(rec_b_ms, rec_o_ms), max(rep_b_ms, rep_o_ms)
    rec_by = "bytes" if rec_b_ms >= rec_o_ms else "operations"
    rep_by = "bytes" if rep_b_ms >= rep_o_ms else "operations"
    print(f"record kernel, density step ({n} lanes): {record_ms:.4f} ms (device time, mean of the kept records of 3 windows of 5 launches); plain version "
          f"{record_plain_ms:.1f} ms; lane-steps {fwd_steps}; {stat_words(rec_st)}; resident blocks "
          f"{occ.record / occ.sms:.2f} / {docc.record / docc.sms:.2f} per SM of {occ.threads} threads (packed / "
          f"dense); {regs_of('trace_lanes_kernel<false, {}, true>')}; read {rec_words}; bound {rec_bound:.5f} ms "
          f"({rec_by}: {rec_bytes} B, {rec_b_ms:.5f} ms; {rec_ops} fp32 ops, {rec_o_ms:.5f} ms) = "
          f"{rec_bound / record_ms:.4f} of the kernel's time on {card}")
    for label in ("longest group first", "index order"):
        st = rep_st[label][0]
        ms = replay_ms if label == "longest group first" else replay_index_ms
        print(f"replay kernel, density step ({n} lanes), {label}: {ms:.4f} ms (device time, mean of two turns, each "
              f"the mean of the kept records of 3 windows of 5: {'/'.join(f'{t:.4f}' for t in turns[label])}); lane-steps {rep_steps} "
              f"({rep_steps / max(fwd_steps, 1):.3f} of the forward's); {stat_words(st)} on {card}")
    print(f"replay kernel, density step: plain version {replay_plain_ms:.1f} ms; resident blocks "
          f"{occ.replay / occ.sms:.2f} / {docc.replay / docc.sms:.2f} per SM (packed / dense); "
          f"{regs_of('replay_lanes_kernel<false, {}>')}; read {rep_words}; {voxels_written} gradient voxels written "
          f"(the grid's distinct voxels, 4 B each); "
          f"bound {rep_bound:.5f} ms ({rep_by}: {rep_bytes} B, {rep_b_ms:.5f} ms; {rep_ops} fp32 ops, "
          f"{rep_o_ms:.5f} ms) = {rep_bound / replay_ms:.4f} of the kernel's time (longest group first) on {card}")
    print("step 0: " + json.dumps({
        "record": {"ms": record_ms, "lane_steps": fwd_steps, "simt": rec_st["simt_efficiency"],
                   "half_idle_share": rec_st["half_idle_share"], "blocks_per_sm": occ.record / occ.sms},
        **{f"replay {label}": {"ms": replay_ms if label == "longest group first" else replay_index_ms,
                               "lane_steps": rep_steps, "simt": rep_st[label][0]["simt_efficiency"],
                               "half_idle_share": rep_st[label][0]["half_idle_share"],
                               "blocks_per_sm": occ.replay / occ.sms} for label in rep_st}}), flush=True)
    del L_p, tf_p, dp, grad_k, acc_i, steps_i, rec_tap, rep_st

    # (d) bench.py's three train cells through make_train_step
    launches, _ = train_cells(card, dev, fog_base, wdas, fog_cam, coords, tpids)
    source = "volume_path_tracer_tpu_torch/csrc/trace_lanes.cu"
    return [
        {"name": "record_lanes", "route": "cuda", "source": source,
         "replaces": "volume_path_tracer_tpu/render/megakernel.py:617", "launches": launches["record"],
         "max_abs_err": record_max_abs, "ms": record_ms, "plain_ms": record_plain_ms, "bound_ms": rec_bound,
         "bound_by": rec_by, "library_ms": None},
        {"name": "replay_lanes", "route": "cuda", "source": source,
         "replaces": "volume_path_tracer_tpu/diff/prb.py:657", "launches": launches["replay"],
         "max_abs_err": replay_max_abs, "ms": replay_ms, "plain_ms": replay_plain_ms, "bound_ms": rep_bound,
         "bound_by": rep_by, "library_ms": None},
        # loss_rays_kernel: in the JAX package XLA ops inside make_render_loss's loss_fn
        {"name": "loss_rays", "route": "cuda", "source": source,
         "replaces": "volume_path_tracer_tpu/diff/inverse.py:174", "launches": launches["loss_rays"],
         "max_abs_err": lr_err, "ms": lr_ms, "plain_ms": lr_plain_ms, "bound_ms": lr_bound, "bound_by": "bytes",
         "library_ms": None},
    ]


def wave_cells(dev):
    """The cells --variants and --compare time, each packed and unpacked:
    {(cell, pack): Scene} for the flagship (256x256 and 1920x1080), the fire
    cell (8-wide rows packed) and the 512^3 cloud."""
    import torch

    from volume_path_tracer_tpu_torch.grids.procedural import fire_plume, fog_sphere
    from volume_path_tracer_tpu_torch.models.medium import Medium
    from volume_path_tracer_tpu_torch.render.renderer import Scene
    from volume_path_tracer_tpu_torch.utils.config import loads_configuration

    flag_grid = fog_sphere(radius=30.0, falloff=6.0)
    flag_cfg = loads_configuration(json.dumps(WDAS_SCENE))
    hd_cfg = loads_configuration(json.dumps(HD_SCENE))
    f_dens, f_temp = fire_plume(height=96, radius=28.0)
    fire_cfg = loads_configuration(json.dumps(FIRE_SCENE))
    cells = {}
    for pack in (True, False):
        flag_med = Medium.from_grids(flag_grid, pack=pack)
        cells["flagship", pack] = Scene.from_config(flag_cfg, flag_med, max_iters=FLAGSHIP_MAX_ITERS)
        cells["flagship 1920x1080", pack] = Scene.from_config(hd_cfg, flag_med, max_iters=FLAGSHIP_MAX_ITERS)
        cells["fire", pack] = Scene.from_config(fire_cfg, Medium.from_grids(f_dens, f_temp, pack=pack),
                                                max_iters=FIRE_MAX_ITERS)
    cloud, _ = big_cloud_cached(512)
    cloud_cfg = dict(WDAS_SCENE, num_waves=2)
    cloud_cfg["camera_parameters"] = dict(WDAS_SCENE["camera_parameters"], position=[900.0, 0.0, 0.0], vfov_deg=40.0)
    cloud_cfg = loads_configuration(json.dumps(cloud_cfg))
    for pack in (True, False):
        cells["512^3", pack] = Scene.from_config(cloud_cfg, Medium.from_grids(cloud, pack=pack),
                                                 max_iters=FLAGSHIP_MAX_ITERS)
    del cloud
    torch.cuda.synchronize()
    return cells


def time_wave_cells(cells, card, label):
    """Wave 1 of every cell of wave_cells, packed and dense side by side:
    render_wave_kernel device ms (CUPTI, kernel_device_ms of 10, or 5 above
    65,536 pixels), the films, and from a measuring launch (not at
    1920x1080) lane-steps, what the wave read, SIMT efficiency and idle
    tail. Prints one line a cell; returns ({cell: {packed_ms, dense_ms}},
    {(cell, pack): film})."""
    import torch

    from volume_path_tracer_tpu_torch.render import megakernel as mk

    summary, films = {}, {}
    for cell in ("flagship", "fire", "512^3", "flagship 1920x1080"):
        got = {}
        for pack in (True, False):
            sc = cells[cell, pack]
            dev = sc.device
            n = sc.width * sc.height
            kw = wave_args(sc, 1)
            film = torch.zeros((sc.height, sc.width, 4), dtype=torch.float32, device=dev)
            mk.render_wave(film=film, pixels=range(0, n), **kw)
            films[cell, pack] = film
            scratch = torch.zeros_like(film)
            ms = kernel_device_ms(lambda: mk.render_wave(film=scratch, pixels=range(0, n), **kw),
                                  5 if n > 65536 else 10, "render_wave_kernel")
            got[pack] = dict(ms=ms)
            if cell != "flagship 1920x1080":
                st, tap = measuring_launch(mk, sc.medium, sc.params, dev, lambda tap, stat: mk.render_wave(
                    film=scratch, pixels=range(0, n), row_tap=tap, stat=stat, **kw), sc.bb_table)
                got[pack].update(st, read=tap_bytes(sc.medium, sc.params, sc.bb_table, tap)[1])
        p, d = got[True], got[False]
        line = (f"{label}, {cell} wave 1: render_wave_kernel packed | dense {p['ms']:.4f} | "
                f"{d['ms']:.4f} ms (dense / packed {d['ms'] / p['ms']:.3f}); dense film bitwise equal to the "
                f"packed film {bool(torch.equal(films[cell, True], films[cell, False]))}")
        if "lane_steps" in p:
            line += (f"; lane-steps {p['lane_steps']} | {d['lane_steps']}; read {p['read']} | {d['read']}; "
                     f"SIMT efficiency {p['simt_efficiency']:.4f} | {d['simt_efficiency']:.4f}; under half of "
                     f"the warps at work for {p['half_idle_share']:.3f} | {d['half_idle_share']:.3f}")
        print(line + f" on {card}", flush=True)
        summary[cell] = {"packed_ms": p["ms"], "dense_ms": d["ms"]}
    return summary, films


# Phase 10: the port's parallel/ layer on the card. Mesh shapes over the one
# card (or over the cards, where there are several), the flagship's waves
# per call and the density train cell through make_train_step(mesh=...).
MESH_SHAPES = ((4, 1), (2, 2))
MESH_TRAIN_STEPS = 4


def mesh_devices(dev, n):
    """n cells' devices: the visible cards in turn, or `dev` n times where
    there is one card (a mesh on one card measures correctness and the
    sharded path's overhead, not scaling)."""
    import torch

    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)] if count > 1 else [dev] * n


def run_example(args, env, timeout=300):
    """Run the multi-process example in len(args) processes at once (one
    argument list each); returns their outputs. Every process is stopped."""
    procs = []
    try:
        for a in args:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "volume_path_tracer_tpu_torch.examples.multihost_render", *a],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        check(p.returncode == 0, f"multihost_render exited with {p.returncode}:\n{out[-3000:]}")
    return outs


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phase(card, dev):
    """Phase 10 on the CUDA device `dev`: the sharded wave and film against
    the one-device render, the sharded train step against mesh=None, the
    multi-process example over NCCL (world size 1) and over gloo (two
    processes on the one card), and the inverse-rendering example. Returns
    the launches of the wave, record, replay and ray-batch kernels on these
    paths."""
    import numpy as np
    import torch

    from volume_path_tracer_tpu_torch.diff import inverse as inv
    from volume_path_tracer_tpu_torch.examples import inverse_rendering
    from volume_path_tracer_tpu_torch.grids.procedural import fog_sphere
    from volume_path_tracer_tpu_torch.models.medium import Medium
    from volume_path_tracer_tpu_torch.parallel import shard
    from volume_path_tracer_tpu_torch.render import megakernel as mk
    from volume_path_tracer_tpu_torch.render.renderer import Scene, render
    from volume_path_tracer_tpu_torch.utils import rng as vrng
    from volume_path_tracer_tpu_torch.utils.config import loads_configuration

    t_phase = time.perf_counter()
    print(f"torch.cuda.device_count() {torch.cuda.device_count()}", flush=True)
    launches = {"render_wave": 0, "render_wave_dense": 0, "record": 0, "replay": 0, "loss_rays": 0}
    flag_cfg = loads_configuration(json.dumps(WDAS_SCENE))
    grid = fog_sphere(radius=30.0, falloff=6.0)
    for pack in (True, False):
        sc = Scene.from_config(flag_cfg, Medium.from_grids(grid, pack=pack), max_iters=FLAGSHIP_MAX_ITERS)
        what = "flagship" if pack else "flagship unpacked"
        W, H, waves = sc.width, sc.height, sc.num_waves
        bb = sc.bb_table
        render(sc)  # warm-up
        one_s = []
        for _ in range(2):
            reset_launch_counts(mk)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            film_1 = render(sc)
            torch.cuda.synchronize()
            one_s.append(time.perf_counter() - t0)
        one = dict(wave=mk.WAVE_LAUNCHES, dense=mk.DENSE_WAVE_LAUNCHES)
        raster, pids, npix = shard.pad_ray_batch(W, H, 4)
        for rays, spp in MESH_SHAPES if pack else MESH_SHAPES[:1]:
            mesh = shard.make_mesh(rays * spp, spp=spp, devices=mesh_devices(dev, rays * spp))
            shard.render_film_sharded(mesh, sc.medium, sc.params, sc.camera, bb, W, H, sc.seed, spp)  # warm-up
            mesh_s = []
            for _ in range(2):
                reset_launch_counts(mk)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                film = shard.render_film_sharded(mesh, sc.medium, sc.params, sc.camera, bb, W, H, sc.seed, waves)
                torch.cuda.synchronize()
                mesh_s.append(time.perf_counter() - t0)
            got = dict(wave=mk.WAVE_LAUNCHES, dense=mk.DENSE_WAVE_LAUNCHES,
                       plain=mk.PLAIN_WAVE_LAUNCHES + mk.PLAIN_LAUNCHES + mk.LAUNCHES)
            launches["render_wave"] += got["wave"] - got["dense"]
            launches["render_wave_dense"] += got["dense"]
            calls = waves // spp
            check(got["wave"] == calls * mesh.size and got["plain"] == 0,
                  f"{what} {rays}x{spp}: {got} launches, expected {calls * mesh.size} wave kernel launches alone")
            # the dense launches per wave launch: the one-device path's
            check(got["dense"] * one["wave"] == one["dense"] * got["wave"],
                  f"{what} {rays}x{spp}: dense launches {got} against one device's {one}")
            if spp == 1:
                ref, same = film_1, bool(torch.equal(film, film_1))
                check(same, f"{what} {rays}x{spp}: the film differs from the one-device render")
                err = 0.0
            else:
                # calls 1..waves/S render global waves S .. waves + S - 1
                ref = torch.zeros_like(film_1)
                for gw in range(spp, waves + spp):
                    mk.render_wave(sc.medium, sc.params, sc.camera, bb, ref, range(0, npix),
                                   vrng.mix_stream(sc.seed, gw), sc.use_jitter, sc.camera.imaging_ratio)
                same = bool(torch.allclose(film, ref, rtol=2e-5, atol=2e-5))
                err = float((film - ref).abs().max())
                check(same, f"{what} {rays}x{spp}: the film differs from sequential waves beyond 2e-5 ({err:.3e})")
            # lane-iterations of one call against the one-device waves it renders
            _, _, _, lanes = shard.render_wave_sharded(mesh, sc.medium, sc.params, sc.camera, bb, raster, pids,
                                                       sc.seed, 1, sc.use_jitter, return_lane_iters=True)
            one_lanes = 0
            for gw in range(spp, 2 * spp):
                scratch = torch.zeros_like(film_1)
                one_lanes += int(mk.render_wave(sc.medium, sc.params, sc.camera, bb, scratch, range(0, npix),
                                                vrng.mix_stream(sc.seed, gw), sc.use_jitter,
                                                sc.camera.imaging_ratio, return_lane_iters=True)[2])
            check(int(lanes) == one_lanes, f"{what} {rays}x{spp}: lane-iterations {int(lanes)} != {one_lanes}")
            print(f"mesh {what} {rays}x{spp} ({mesh.size} cells on {len({str(d) for d in mesh.devices.flat})} "
                  f"device(s)), {W}x{H}x{waves}: film {'bitwise equal to the one-device render' if spp == 1 else f'within 2e-5 of sequential waves {spp}..{waves + spp - 1} (max abs {err:.3e})'}; "
                  f"lane-iterations of wave 1 {int(lanes)} = one device's {one_lanes}; launches {got} "
                  f"(one device: {one}); rays/s {npix * waves / min(mesh_s):.1f} (render only, best of 2: "
                  f"{[round(t, 4) for t in mesh_s]} s) against one device's render {npix * waves / min(one_s):.1f} "
                  f"({[round(t, 4) for t in one_s]} s) on {card}", flush=True)
        del sc, film, film_1

    # The density train cell (bench.py:287-304, unpacked: make_train_step's
    # default) on a 2x1 mesh against mesh=None: one step from the same
    # grids, then steps timed.
    med, fog_base, wdas, fog_cam, coords, tpids, _ = density_step(dev)
    del med
    target = torch.zeros((TRAIN_SIZE * TRAIN_SIZE, 3), dtype=torch.float32, device=dev)
    start = inv.param_from_density(fog_base.density.data)
    results = {}
    for label, mesh in (("one device", None), ("2x1", shard.make_mesh(2, devices=mesh_devices(dev, 2)))):
        grids = inv.OptimizableGrids(start.clone().requires_grad_(True))
        opt = inv.make_optimizer(grids)
        step = inv.make_train_step(fog_base, wdas, fog_cam, None, n_iters=TRAIN_ITERS, samples_per_step=TRAIN_K,
                                   mesh=mesh)
        grids, opt, loss = step(grids, opt, coords, tpids, target, (3, 1))
        first = (float(loss), grids.log_density.grad.clone())
        reset_launch_counts(mk)
        graph = getattr(step, "graph", None)  # one device's step replays a CUDA graph after its first
        graph_counts = (graph.captures, graph.replays) if graph is not None else (0, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MESH_TRAIN_STEPS):
            grids, opt, loss = step(grids, opt, coords, tpids, target, (3, 2 + i))
        float(loss)
        dt = time.perf_counter() - t0
        cells = 1 if mesh is None else mesh.size
        bodies = MESH_TRAIN_STEPS - ((graph.replays - graph_counts[1]) - (graph.captures - graph_counts[0])
                                     if graph is not None else 0)
        check(mk.RECORD_LAUNCHES == mk.REPLAY_LAUNCHES == bodies * cells
              and mk.PLAIN_RECORD_LAUNCHES + mk.PLAIN_REPLAY_LAUNCHES == 0,
              f"train {label}: {mk.RECORD_LAUNCHES} record / {mk.REPLAY_LAUNCHES} replay launches in "
              f"{MESH_TRAIN_STEPS} steps of {cells} cell(s), {bodies} of them run on the host")
        check(mk.LOSS_RAYS_LAUNCHES == bodies * cells and mk.PLAIN_LOSS_RAYS_LAUNCHES == 0,
              f"train {label}: {mk.LOSS_RAYS_LAUNCHES} loss_rays_kernel launches and {mk.PLAIN_LOSS_RAYS_LAUNCHES} "
              f"plain ray batches in {MESH_TRAIN_STEPS} steps of {cells} cell(s)")
        if mesh is not None:
            launches["record"] += mk.RECORD_LAUNCHES
            launches["replay"] += mk.REPLAY_LAUNCHES
            launches["loss_rays"] += mk.LOSS_RAYS_LAUNCHES
        results[label] = first + (TRAIN_SIZE * TRAIN_SIZE * TRAIN_K * MESH_TRAIN_STEPS / dt,)
    (l1, g1, r1), (l2, g2, r2) = results["one device"], results["2x1"]
    g_ok = bool(torch.allclose(g2, g1, rtol=1e-4, atol=1e-6))
    l_ok = abs(l2 - l1) <= 1e-5 * abs(l1)
    print(f"mesh train density cell ({TRAIN_SIZE}x{TRAIN_SIZE} x {TRAIN_K}, unpacked) 2x1 against mesh=None: loss "
          f"{l2:.7g} vs {l1:.7g} (rtol 1e-5: {l_ok}), gradients within rtol 1e-4, atol 1e-6: {g_ok} (max abs "
          f"diff {float((g2 - g1).abs().max()):.3e} of max {float(g1.abs().max()):.3e}); train rays/s {r2:.1f} "
          f"against {r1:.1f} on one device ({MESH_TRAIN_STEPS} steps, host clock) on {card}", flush=True)
    check(l_ok and g_ok, "the sharded train step differs from the one-device step")
    del fog_base, coords, tpids, target, start, results

    # The multi-process example at its defaults (1024x1024, 8 waves): NCCL at
    # world size 1, then two processes on the one card over gloo (NCCL
    # refuses two ranks on one device); the films equal.
    env = dict(os.environ, PYTHONPATH=REPO, LOCAL_RANK="0")
    dumps = {k: os.path.join(OUT_DIR, f"multihost_{k}.npz") for k in ("nccl", "gloo")}
    out_nccl = run_example([["--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1",
                             "--process-id", "0", "--dump", dumps["nccl"]]], env)[0]
    port = free_port()
    outs_gloo = run_example([["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(i),
                              "--backend", "gloo", "--dump", dumps["gloo"]] for i in range(2)], env)
    films = {k: np.load(v)["film"] for k, v in dumps.items()}
    same = bool(np.array_equal(films["nccl"], films["gloo"]))

    def rate(out):
        line = next(x for x in out.splitlines() if "rays/s total" in x)
        return line[line.index("[multihost] ") + 12:]

    print(f"multihost_render, NCCL at world size 1: {rate(out_nccl)}", flush=True)
    print(f"multihost_render, two processes on one card over gloo (its all_reduce takes the CUDA tensors): "
          f"{rate(outs_gloo[0])}; film bitwise equal to the one-process film {same}; film mean w "
          f"{float(films['gloo'][..., 3].mean())} on {card}", flush=True)
    check(same, "the two-process film differs from the one-process film")
    check(np.isfinite(films["gloo"]).all() and (films["gloo"][..., 3] == 8).all(),
          "the multi-process film is not finite or has wrong weights")

    # The inverse-rendering example at its defaults, in this process.
    for extra in ([], ["--joint"]):
        s = inverse_rendering.main(extra + ["--out", os.path.join(OUT_DIR, "inverse" + "_joint" * bool(extra))])
        if extra:
            # The joint example's temperature error falls, then drifts up
            # again at its default 60 steps (Adam at 0.3 on the temperature
            # overshoots): the gate is that the curve went well below the
            # start and ended finite, not above 1.1 times the start.
            best = min(s["curve"], key=lambda c: c["temp_mae"])
            msg = (f"temperature error {s['temp_mae_init']} -> {s['temp_mae_final']} (density-weighted MAE; least "
                   f"{best['temp_mae']} at step {best['step']}), correlation {s['temp_corr_final']}")
            ok = (best["temp_mae"] < 0.8 * s["temp_mae_init"] and all(np.isfinite(c["loss"]) for c in s["curve"])
                  and np.isfinite(s["temp_mae_final"]) and s["temp_mae_final"] <= 1.1 * s["temp_mae_init"])
        else:
            msg = f"voxel correlation {s['vox_corr']:.4f}"
            ok = s["vox_corr"] > 0.3 and s["loss_last"] < s["loss_first"]
        print(f"inverse_rendering {'--joint' if extra else 'density'} ({s['steps']} steps, "
              f"{s.get('train_steps', s['steps'])} train steps): {s['steps_per_s']:.2f} train steps/s, loss "
              f"{s['loss_first']:.6g} -> {s['loss_last']:.6g}, {msg} on {card}", flush=True)
        check(ok, f"inverse_rendering {extra}: no recovery")
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# Phase 11: the bench's primary and phase 4 time the same 16 flagship waves
# through the same kernel, so their rays/s may differ only by the host work
# around the launches.
BENCH_RTOL = 0.10
# The launch counters of render.megakernel that the bench's primary may move
# (the wave kernel) and those it must leave at 0.
BENCH_COUNTERS = ("WAVE_LAUNCHES", "DENSE_WAVE_LAUNCHES", "LAUNCHES", "DENSE_LAUNCHES",
                  "RECORD_LAUNCHES", "REPLAY_LAUNCHES", "DENSE_RECORD_LAUNCHES",
                  "DENSE_REPLAY_LAUNCHES", "PLAIN_WAVE_LAUNCHES", "PLAIN_LAUNCHES", "PLAIN_RECORD_LAUNCHES",
                  "PLAIN_REPLAY_LAUNCHES", "LOSS_RAYS_LAUNCHES", "PLAIN_LOSS_RAYS_LAUNCHES")


def bench_phase(card, dev, build_s, render_rays_s=None):
    """Phase 11: the port's bench (volume_path_tracer_tpu_torch/bench.py) on
    the card. Its primary at bench.py's full size, with every launch counter
    set to 0 just before and read just after: its waves go through
    render_wave_kernel alone, its film is bitwise the main path's (render) on
    the same medium and waves, and its rays/s is within BENCH_RTOL of phase
    4's render-part rays/s (render_rays_s; measured here the same way when
    phase 4 did not run). Prints the bench's JSON line. Then the flagship
    half of the bench's --verify with every gate. Returns the primary's
    launches of each kernel, named as in the kernels line."""
    import torch

    from volume_path_tracer_tpu_torch import bench
    from volume_path_tracer_tpu_torch.grids.procedural import fog_sphere
    from volume_path_tracer_tpu_torch.models.medium import Medium
    from volume_path_tracer_tpu_torch.render import megakernel as mk
    from volume_path_tracer_tpu_torch.render.renderer import Scene, render
    from volume_path_tracer_tpu_torch.utils.config import loads_configuration

    flag = Scene.from_config(loads_configuration(json.dumps(WDAS_SCENE)),
                             Medium.from_grids(fog_sphere(radius=30.0, falloff=6.0)), max_iters=FLAGSHIP_MAX_ITERS)
    if render_rays_s is None:
        png = os.path.join(OUT_DIR, "flagship.png")
        render_passes(flag, 1, png)  # warm-up, as phase 4
        render_rays_s = main_path(flag, 3, png, "flagship", card)[4]
    reset_launch_counts(mk)
    t0 = time.perf_counter()
    res = bench.bench_primary(dev)
    primary_s = time.perf_counter() - t0
    counts = {name: getattr(mk, name) for name in BENCH_COUNTERS}
    line = bench.primary_line(res, bench.card(dev), round(build_s, 2))
    main_film = render(flag)
    same = bool(torch.equal(res.film, main_film))
    ratio = res.rays_per_s / render_rays_s
    print(f"bench primary: {res.rays_per_s:.1f} rays/s (best of 5 passes of 16 waves, {primary_s:.2f} s with the "
          f"medium's build), phase 4's render part {render_rays_s:.1f} rays/s (ratio {ratio:.4f}); launches "
          f"{json.dumps(counts)}; n_capped {res.n_capped}; film bitwise equal to render's {same} on {card}")
    print(json.dumps(line), flush=True)
    waves = 16 * 6  # the warm-up pass and 5 timed passes
    check(counts["WAVE_LAUNCHES"] == waves and all(v == 0 for k, v in counts.items() if k != "WAVE_LAUNCHES"),
          f"the bench's primary did not go through render_wave_kernel alone: {counts}")
    check(same, "the bench's film differs from the main path's film of the same waves")
    check(abs(ratio - 1.0) <= BENCH_RTOL,
          f"the bench's rays/s is {ratio:.4f} of phase 4's render part, beyond {BENCH_RTOL}")
    del res, main_film, flag

    t0 = time.perf_counter()
    medium, camera = bench._flagship(dev)
    v = bench.verify_scene({}, "", medium, camera, bench._wdas_params())
    print(f"bench --verify, flagship half ({time.perf_counter() - t0:.1f} s): every gate held on {card}")
    print(json.dumps(v), flush=True)
    return {"render_wave": counts["WAVE_LAUNCHES"] - counts["DENSE_WAVE_LAUNCHES"],
            "trace_lanes": counts["LAUNCHES"] - counts["DENSE_LAUNCHES"],
            "render_wave_dense": counts["DENSE_WAVE_LAUNCHES"], "trace_lanes_dense": counts["DENSE_LAUNCHES"],
            "record_lanes": counts["RECORD_LAUNCHES"], "replay_lanes": counts["REPLAY_LAUNCHES"],
            "loss_rays": counts["LOSS_RAYS_LAUNCHES"]}


def compare(repo_dir):
    """python3 chip_smoke.py --compare [DIR]

    The port in the checkout DIR (default: this one), timed so that two
    commits compare on one card: run it for each, in turns (parent, change,
    change, parent), in one call. Each run uses its own checkout's
    kernels, wrappers and media. Prints wave 1 of the flagship, fire, 512^3
    and 1920x1080 cells packed and dense (time_wave_cells) with a SHA-1 of
    each film (equal films across commits have equal digests), the record
    and replay kernels' device times on bench.py's density step, packed and
    dense (CUPTI, kernel_device_ms of 5), and the three train cells (phase 9
    (d)), then one JSON line. Works for any commit of the port that has the
    gradient path.
    """
    import hashlib

    import numpy as np
    import torch

    repo_dir = os.path.abspath(repo_dir)
    check(torch.cuda.is_available(), "CUDA is not available")
    sys.path.insert(0, repo_dir)
    from volume_path_tracer_tpu_torch.diff import inverse as inv
    from volume_path_tracer_tpu_torch.render import megakernel as mk

    check(os.path.dirname(mk.__file__).startswith(repo_dir), f"the port was imported from {mk.__file__}")
    dev = torch.device("cuda", 0)
    card = gpu_name_and_limit()
    print(f"comparison of {repo_dir} on {card}", flush=True)
    t0 = time.perf_counter()
    mk.build()
    print(f"build_s {time.perf_counter() - t0:.2f}")
    cells = wave_cells(dev)
    waves, films = time_wave_cells(cells, card, "compare")
    digests = {f"{cell} {'packed' if pack else 'dense'}": hashlib.sha1(f.cpu().numpy().tobytes()).hexdigest()[:16]
               for (cell, pack), f in films.items()}
    print("film digests: " + json.dumps(digests), flush=True)
    del cells, films
    med, fog_base, wdas, fog_cam, coords, tpids, rays = density_step(dev)
    dense_med = inv.medium_with_params(fog_base, inv.OptimizableGrids(inv.param_from_density(
        fog_base.density.data)), pack=False)
    g = torch.tensor(np.random.default_rng(2).uniform(0.2, 1.0, (rays[2].shape[0], 3)), dtype=torch.float32,
                     device=dev)
    grads = {}
    for layout, m in (("packed", med), ("dense", dense_med)):
        rec_ms, rep_ms = grad_kernel_times(mk, m, wdas, rays, g)
        grads[layout] = {"record_ms": rec_ms, "replay_ms": rep_ms}
        print(f"density step {layout}: record kernel "
              f"{rec_ms:.4f} ms, replay kernel {rep_ms:.4f} ms (device time, mean of the kept records of 3 "
              f"windows of 5 launches) on {card}", flush=True)
    del med, dense_med
    _, train = train_cells(card, dev, fog_base, wdas, fog_cam, coords, tpids)
    print("compare: " + json.dumps({"repo": repo_dir, "waves": waves, "density_step": grads, "cells": train,
                                    "film_digests": digests}))
    record_summary()
    return 0


def main(only=None):
    """The whole run; only="9", "10" or "11" (--phase 9, 10, 11): phases 1,
    2 and that phase, printing no kernels line and no result line."""
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
    from volume_path_tracer_tpu_torch.models.camera import Camera
    from volume_path_tracer_tpu_torch.models.medium import Medium
    from volume_path_tracer_tpu_torch.render import integrator as integ
    from volume_path_tracer_tpu_torch.render import megakernel as mk
    from volume_path_tracer_tpu_torch.render.renderer import (
        Scene, pixel_coords, render, render_rays_wave, render_wave_image)
    from volume_path_tracer_tpu_torch.utils import rng as vrng
    from volume_path_tracer_tpu_torch.utils.config import CameraParameters, loads_configuration
    from volume_path_tracer_tpu_torch.utils.spectral import blackbody_xyz_table

    dev = torch.device("cuda", 0)
    card = gpu_name_and_limit()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    os.makedirs(OUT_DIR, exist_ok=True)

    phase("2 build")
    # Both sources at once, one compiler each: nvcc for the lane kernels,
    # g++ for the .nvdb core that phase 6 uses.
    from concurrent.futures import ThreadPoolExecutor

    from volume_path_tracer_tpu_torch.grids import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        nvdb_core = pool.submit(native.available)
        lib_path = mk.build()
        mk._library()
        nvcc_s = time.perf_counter() - t0
        nvdb_core.result()
    print(f"build_s {time.perf_counter() - t0:.2f}  ({os.path.basename(lib_path)} {nvcc_s:.2f} s, the .nvdb core "
          f"{'built' if native.available() else 'not built'})")
    with open(lib_path + ".log") as f:
        for line in f:
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  " + line.strip()[:160])
    for form, dense in (("packed", False), ("dense", True)):
        occ = mk.occupancy(dev, dense)
        print(f"occupancy ({form}): resident blocks of {occ.threads} threads per SM on "
              f"{occ.sms} SMs: render_wave_kernel {occ.wave / occ.sms:.2f}, trace_lanes_kernel "
              f"{occ.trace / occ.sms:.2f}, its record instantiation {occ.record / occ.sms:.2f}, replay_lanes_kernel "
              f"{occ.replay / occ.sms:.2f}")
    if only == "9":
        phase("9 train")
        train_phase(card, dev)
        record_summary()
        print(card)
        return 0
    if only == "10":
        phase("10 mesh")
        print("mesh launches: " + json.dumps(mesh_phase(card, dev)))
        print(card)
        return 0
    if only == "11":
        phase("11 bench")
        print("bench launches: " + json.dumps(bench_phase(card, dev, nvcc_s)))
        print(card)
        return 0

    # ------------------------------------------------------------------
    phase("3 kernels vs plain")
    flag_cfg = loads_configuration(json.dumps(WDAS_SCENE))
    flag_med = Medium.from_grids(fog_sphere(radius=30.0, falloff=6.0))
    flag = Scene.from_config(flag_cfg, flag_med, max_iters=FLAGSHIP_MAX_ITERS)
    W, H = flag.width, flag.height
    coords = torch.from_numpy(pixel_coords(W, H)).to(dev)
    pids = torch.arange(W * H, dtype=torch.int32, device=dev)
    stream = vrng.mix_stream(flag.seed, 1)
    u_jit = vrng.counter_uniforms(pids, stream, mk.JITTER_COUNTER, 2)
    o_w, d_w = flag.camera.generate_rays(coords, u_jit * 0.5)
    sf0, si0 = mk.pack_state(integ.init_state(flag_med, o_w, d_w, flag.params))
    streams = integ.lane_streams(stream, W * H, dev)

    # (a) trace_lanes: one step on a mid-flight state (20 plain steps in)
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
    # the same step by the dense instantiation, on the same medium unpacked
    flag_dense = Medium.from_grids(fog_sphere(radius=30.0, falloff=6.0), pack=False)
    dpf, dpi = mk.trace_lanes_plain(flag_dense, flag.params, None, sf_mid, si_mid, pids, streams, 1)
    dkf, dki = mk.trace_lanes(flag_dense, flag.params, None, sf_mid, si_mid, pids, streams, 1)
    torch.cuda.synchronize()
    df_ok = torch.isclose(dkf, dpf, rtol=1e-5, atol=1e-6).all(0)
    dense_step_agree = float(df_ok.float().mean())
    dense_step_max_abs = float((dkf - dpf).abs().max())
    dense_step_same = bool(torch.equal(dkf, kf) and torch.equal(dki, ki))
    print(f"one step, dense instantiation: agree {dense_step_agree:.6f} with its plain version, "
          f"max_abs_err {dense_step_max_abs:.3e}; bitwise equal to the packed kernel's step: "
          f"{dense_step_same}; plain unpacked bitwise equal to plain packed: "
          f"{bool(torch.equal(dpf, pf) and torch.equal(dpi, pi))}")
    check(dense_step_agree >= 0.99, f"dense one-step agreement {dense_step_agree} < 0.99")
    check(bool((dki == dpi).all(0)[df_ok].all()), "dense: integer fields differ where the float fields agree")
    check(dense_step_same, "the dense step differs from the packed step on the same medium")

    # (b) full traces on the three scenes of tests/test_megakernel.py:
    # trace_lanes on a ray batch, render_wave through a small camera
    dens, temp = fire_plume(height=40, radius=10.0)
    temp_al = dense_grid_from_array(temp.data, temp.origin_ijk, temp.voxel_size, (0.0, 0.0, 0.0))
    bb = torch.from_numpy(blackbody_xyz_table()).to(dev)
    fire_cam = CameraParameters((60.0, 20.0, 0.0), (0.0, 20.0, 0.0), (0.0, 1.0, 0.0), 40.0, 0.1)
    fog_cam = CameraParameters((45.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 40.0, 0.1)
    cases = [
        ("fog_sphere", (fog_sphere(radius=12.0, falloff=3.0),),
         integ.IntegratorParams(**FOG_PARAMS), None, (-14, 14), (-14, 14), fog_cam),
        ("fire_plume_8wide", (dens, temp),
         integ.IntegratorParams(**FIRE_PARAMS), bb, (5, 35), (-10, 10), fire_cam),
        ("fire_plume_16wide", (dens, temp_al),
         integ.IntegratorParams(**FIRE_PARAMS), bb, (5, 35), (-10, 10), fire_cam),
    ]
    N, SW, SH = 2048, 64, 32
    for name, grids, prm, bbt, yr, zr, cam_p in cases:
        rng = np.random.default_rng(0)
        o = np.stack([np.full(N, -40.0), rng.uniform(*yr, N), rng.uniform(*zr, N)], -1)
        o = torch.tensor(o, dtype=torch.float32, device=dev)
        d = torch.tensor([[1.0, 0.0, 0.0]], device=dev).expand(N, 3).contiguous()
        lp = torch.arange(N, dtype=torch.int32, device=dev)
        s = vrng.mix_stream(3, 1)
        cam = Camera.from_parameters(cam_p, (SW, SH))
        packed = None
        for pack in (True, False):
            med = Medium.from_grids(*grids, pack=pack)
            layout = f"{med.density_rows.shape[1]}-wide rows" if pack else "unpacked, dense instantiation"
            L_k, _, nc_k = mk.trace_rays_fused(med, prm, bbt, o, d, lp, s)
            sfa, sia = mk.pack_state(integ.init_state(med, o, d, prm))
            sfp, sip = mk.trace_lanes_plain(med, prm, bbt, sfa, sia, lp, integ.lane_streams(s, N, dev),
                                            prm.max_iters)
            trace_statistic(L_k.cpu().numpy(), int(nc_k), sfp[10:13].T.cpu().numpy(),
                            int((sip[1] != integ.DONE).sum()), f"trace_lanes {name} ({layout}, {N} lanes)")
            films = [torch.zeros((SH, SW, 4), dtype=torch.float32, device=dev) for _ in range(2)]
            wave = (med, prm, cam, bbt)
            it_k, nc_k = mk.render_wave(*wave, films[0], range(0, SW * SH), s, True, 0.1)
            it_p, nc_p, li_p = mk.render_wave_plain(*wave, films[1], range(0, SW * SH), s, True, 0.1,
                                                    return_lane_iters=True)
            film_statistic(films[0], int(nc_k), films[1], int(nc_p),
                           f"render_wave {name} ({layout}, {SW}x{SH} pixels; longest lane "
                           f"{int(it_k)} vs {int(it_p)})")
            lane_iters_check(mk, films[0], dict(medium=med, params=prm, camera=cam, bb_table=bbt,
                                                pixels=range(0, SW * SH), stream=s, use_jitter=True,
                                                imaging_ratio=0.1), li_p, f"{name} ({layout})")
            if pack:
                packed = (L_k, films[0])
                continue
            # The dense kernel against the packed kernel. Required bitwise
            # where both read the temperature through its own transform (or
            # none); the 16-wide rows carry it in the density grid's frame
            # instead, another arithmetic: the line says what it found.
            same = bool(torch.equal(L_k, packed[0])), bool(torch.equal(films[0], packed[1]))
            close = float(torch.isclose(films[0], packed[1], rtol=1e-4, atol=1e-5).all(-1).float().mean())
            print(f"dense against packed kernel, {name}: trace_lanes bitwise equal {same[0]}, "
                  f"render_wave bitwise equal {same[1]}, pixels close {close:.4f}")
            if name != "fire_plume_16wide":
                check(all(same), f"{name}: the dense kernels differ from the packed kernels")
            check(close > 0.95, f"{name}: dense and packed films differ on {1 - close:.3f} of the pixels")
    del packed, films, med

    # ------------------------------------------------------------------
    phase("4 flagship main path")
    png = os.path.join(OUT_DIR, "flagship.png")
    render_passes(flag, 1, png)  # warm-up: first-call allocations and caches
    times, flag_rays_s, ncap, flag_counts, flag_render_rays_s = main_path(flag, 3, png, "flagship", card)
    check(ncap == 0, f"{ncap} flagship rays truncated at the step cap")
    flag_best_s = min(times)

    # render_wave alone at the main path's shapes (wave 1), held against its
    # plain version on the same inputs.
    n = W * H
    kw = wave_args(flag, 1)
    film_k = torch.zeros((H, W, 4), dtype=torch.float32, device=dev)
    it_k, nc_k = mk.render_wave(film=film_k, pixels=range(0, n), **kw)
    torch.cuda.synchronize()
    film_p = torch.zeros_like(film_k)
    t0 = time.perf_counter()
    it_p, nc_p, li_p = mk.render_wave_plain(film=film_p, pixels=range(0, n), **kw, return_lane_iters=True)
    torch.cuda.synchronize()
    wave_plain_ms = (time.perf_counter() - t0) * 1e3
    film_statistic(film_k, int(nc_k), film_p, int(nc_p),
                   f"render_wave flagship wave ({n} pixels, max_iters {FLAGSHIP_MAX_ITERS}; longest lane "
                   f"{int(it_k)} vs {int(it_p)})")
    wave_lane_iters = (lane_iters_check(mk, film_k, dict(kw, pixels=range(0, n)), li_p, "flagship wave"),
                       int(li_p))
    wave_max_abs = float((film_k - film_p).abs().max())
    # Other ranges and a second launch of the same kernel: lanes land on
    # other threads and refill in another order, and nothing may show.
    film_c = torch.zeros_like(film_k)
    for start in range(0, n, 10_000):
        mk.render_wave(film=film_c, pixels=range(start, min(start + 10_000, n)), **kw)
    film_r = torch.zeros_like(film_k)
    mk.render_wave(film=film_r, pixels=range(0, n), **kw)
    perm = torch.randperm(n, device=dev, generator=torch.Generator(device=dev).manual_seed(0)).to(torch.int32)
    film_s = torch.zeros_like(film_k)
    mk.render_wave(film=film_s, pixels=perm, **kw)
    torch.cuda.synchronize()
    same = [bool(torch.equal(film_k, f)) for f in (film_c, film_r, film_s)]
    print(f"render_wave flagship wave: chunked (7 ranges) bitwise equal {same[0]}, repeated bitwise equal "
          f"{same[1]}, pixel ids in a random order bitwise equal {same[2]}; max_abs_err against the plain "
          f"version {wave_max_abs:.3e} (on lanes where rounding flips an event)")
    check(all(same), "render_wave depends on how pixels are split or ordered")
    wave_rep = wave_kernel_report(flag, "flagship", card)
    print(f"render_wave flagship wave: plain version {wave_plain_ms:.1f} ms")
    # The same scene at the size the flagship was cut from: a wave of 31 times
    # the card's resident threads, where every warp refills many times.
    wave_kernel_report(Scene.from_config(loads_configuration(json.dumps(HD_SCENE)), flag_med,
                                         max_iters=FLAGSHIP_MAX_ITERS), "flagship at 1920x1080", card)

    # trace_lanes alone on the same wave (state in, state out).
    def kernel_wave(tap=None, stat=None):
        return mk.trace_lanes(flag_med, flag.params, None, sf0, si0, pids, streams,
                              FLAGSHIP_MAX_ITERS, row_tap=tap, stat=stat)

    sf_k, si_k = kernel_wave()
    wrapper_ms = cuda_ms(kernel_wave, 10)
    t0 = time.perf_counter()
    sf_p, si_p = mk.trace_lanes_plain(flag_med, flag.params, None, sf0, si0, pids, streams,
                                      FLAGSHIP_MAX_ITERS)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    trace_statistic(sf_k[10:13].T.cpu().numpy(), int((si_k[1] != integ.DONE).sum()),
                    sf_p[10:13].T.cpu().numpy(), int((si_p[1] != integ.DONE).sum()),
                    f"trace_lanes flagship wave ({n} lanes, max_steps {FLAGSHIP_MAX_ITERS})")
    kernel_ms = kernel_device_ms(kernel_wave, 10, "trace_lanes_kernel")
    # The bound counts each byte once: the state read and written, pixel ids
    # and streams (int32), and every table row the run reads, as the kernel
    # itself marks them (row_tap); the parameters (< 400 B) are left out.
    state_bytes = (len(mk.STATE_F32) + len(mk.STATE_I32)) * 4 * 2 + 8

    def trace_lanes_report(medium, si_out, ms, wrapper, plain, what):
        """The bound of one trace_lanes wave, from one measuring launch on
        `medium`; prints the kernel's line and returns (bound_ms, bound_by)."""
        tap = mk.new_row_tap(medium, flag.params, None)
        stat = mk.launch_stat(dev)
        mk.trace_lanes(medium, flag.params, None, sf0, si0, pids, streams, FLAGSHIP_MAX_ITERS,
                       row_tap=tap, stat=stat)
        torch.cuda.synchronize()
        tl = mk.read_launch_stat(stat)
        lane_steps = int(si_out[2].to(torch.int64).sum())
        check(tl["lane_steps"] == lane_steps, "the kernel's step count differs from the lane counters' sum")
        row_bytes, read_words = tap_bytes(medium, flag.params, None, tap)
        bytes_moved = n * state_bytes + row_bytes
        b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        o_ms = lane_steps * OPS_PER_LANE_STEP / FP32_OPS_PER_S * 1e3
        by = "bytes" if b_ms >= o_ms else "operations"
        print(f"trace_lanes one flagship wave, {what} ({n} lanes): kernel {ms:.4f} ms (device time, "
              f"mean of the kept records of 3 windows of 10 launches), wrapper {wrapper:.4f} ms (CUDA events, mean of 10); plain version "
              f"{plain:.1f} ms; lane-steps {lane_steps} (longest lane {int(si_out[2].max())}); "
              f"read {read_words}; bound {max(b_ms, o_ms):.5f} ms ({by}: {bytes_moved} B = "
              f"{n * state_bytes} B state + {row_bytes} B of the medium, {b_ms:.5f} ms; "
              f"{lane_steps * OPS_PER_LANE_STEP} fp32 ops, {o_ms:.5f} ms); SIMT efficiency as issued "
              f"{tl['simt_efficiency']:.4f}, under half of the warps at work for {tl['half_idle_share']:.3f} "
              f"of the measuring launch on {card}")
        return max(b_ms, o_ms), by

    bound_ms, bound_by = trace_lanes_report(flag_med, si_k, kernel_ms, wrapper_ms, plain_ms, "8-wide rows")
    # What holds the lane loop: the SIMT efficiency one thread per lane would
    # have with no refill (from the lane counters), and the device time
    # against max_steps (the slope over the first steps is a step's cost on
    # a full card, the tail past 64 the cost of draining).
    print(f"one thread per lane, no refill, would have: SIMT efficiency {mk.simt_efficiency(si_k[2], 32):.4f} "
          f"per warp of 32, {mk.simt_efficiency(si_k[2], 128):.4f} per block of 128")
    sweep = {}
    for ms in (8, 16, 32, 64, 128, 309, FLAGSHIP_MAX_ITERS):
        sweep[ms] = kernel_device_ms(
            lambda: mk.trace_lanes(flag_med, flag.params, None, sf0, si0, pids, streams, ms),
            10, "trace_lanes_kernel")
    print("trace_lanes device ms against max_steps (flagship wave, mean of the kept records of 3 windows of 10 launches): "
          + ", ".join(f"{k}: {v:.4f}" for k, v in sweep.items()))

    # The ray-batch path: render_rays_wave hands a batch's contribution to
    # its caller and goes through trace_lanes. Two waves, against the films
    # the wave kernel makes of them (other ray arithmetic: the statistic).
    reset_launch_counts(mk)
    contribs = [render_rays_wave(flag_med, flag.params, flag.camera, None, coords, pids, flag.seed, w,
                                 flag.use_jitter, flag.camera.imaging_ratio) for w in (1, 2)]
    trace_launches, trace_plain = mk.LAUNCHES, mk.PLAIN_LAUNCHES
    check(trace_launches == 2 and trace_plain == 0 and mk.WAVE_LAUNCHES == 0 and mk.DENSE_LAUNCHES == 0,
          "render_rays_wave did not go through trace_lanes_kernel")
    for w, (contrib, _, nc) in zip((1, 2), contribs):
        film_w, nc_w = render_wave_image(flag, w, return_ncap=True)
        film_statistic(contrib, int(nc), film_w, int(nc_w), f"render_rays_wave against render_wave, wave {w}")
    del film_c, film_r, film_s, contribs

    profile_pass(flag, os.path.join(OUT_DIR, "flagship_profiled.png"), flag_best_s, "flagship")

    # ---- the same medium unpacked: the dense instantiations ----
    # One whole wave by each dense kernel against its plain version (the
    # statistic the packed kernels are held to) and against the packed
    # kernel's result (the same corners in the same order: bitwise).
    dflag = Scene.from_config(flag_cfg, flag_dense, max_iters=FLAGSHIP_MAX_ITERS)
    dkw = wave_args(dflag, 1)
    film_dp = torch.zeros((H, W, 4), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    it_dp, nc_dp, li_dp = mk.render_wave_plain(film=film_dp, pixels=range(0, n), **dkw, return_lane_iters=True)
    torch.cuda.synchronize()
    dense_wave_plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    sf_dp, si_dp = mk.trace_lanes_plain(flag_dense, flag.params, None, sf0, si0, pids, streams,
                                        FLAGSHIP_MAX_ITERS)
    torch.cuda.synchronize()
    dense_plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"flagship wave, plain versions on the unpacked medium: render_wave_plain {dense_wave_plain_ms:.1f} ms "
          f"(bitwise equal to plain packed {bool(torch.equal(film_dp, film_p))}), trace_lanes_plain "
          f"{dense_plain_ms:.1f} ms")
    film_d = torch.zeros((H, W, 4), dtype=torch.float32, device=dev)
    it_d, nc_d = mk.render_wave(film=film_d, pixels=range(0, n), **dkw)
    torch.cuda.synchronize()
    film_statistic(film_d, int(nc_d), film_dp, int(nc_dp), f"render_wave flagship wave, dense instantiation "
                   f"(longest lane {int(it_d)} vs {int(it_dp)})")
    wave_max_abs_d = float((film_d - film_dp).abs().max())
    lane_iters_d = (lane_iters_check(mk, film_d, dict(dkw, pixels=range(0, n)), li_dp, "flagship wave, dense"),
                    int(li_dp))
    film_same = bool(torch.equal(film_d, film_k))
    print(f"render_wave flagship wave: dense film bitwise equal to the packed kernel's "
          f"{film_same}; max_abs_err against the plain version {wave_max_abs_d:.3e}")
    check(film_same, "the dense wave kernel's flagship film differs from the packed kernel's")
    wave_rep_d = wave_kernel_report(dflag, "flagship, dense instantiation", card)
    dense_beside_packed(wave_rep, wave_rep_d, "flagship", card)

    def dense_kernel_wave():
        return mk.trace_lanes(flag_dense, flag.params, None, sf0, si0, pids, streams, FLAGSHIP_MAX_ITERS)

    sf_d, si_d = dense_kernel_wave()
    wrapper_ms = cuda_ms(dense_kernel_wave, 10)
    trace_statistic(sf_d[10:13].T.cpu().numpy(), int((si_d[1] != integ.DONE).sum()),
                    sf_dp[10:13].T.cpu().numpy(), int((si_dp[1] != integ.DONE).sum()),
                    f"trace_lanes flagship wave, dense instantiation ({n} lanes)")
    check(bool(torch.equal(sf_d, sf_k) and torch.equal(si_d, si_k)),
          "the dense trace_lanes kernel's flagship state differs from the packed kernel's")
    trace_ms = kernel_device_ms(dense_kernel_wave, 10, "trace_lanes_kernel")
    t_bound_ms, t_bound_by = trace_lanes_report(flag_dense, si_d, trace_ms, wrapper_ms, dense_plain_ms, "unpacked")
    # the unpacked ray-batch path
    reset_launch_counts(mk)
    d_contrib, _, d_nc = render_rays_wave(flag_dense, flag.params, flag.camera, None, coords, pids, flag.seed, 1,
                                          flag.use_jitter, flag.camera.imaging_ratio)
    check(mk.DENSE_LAUNCHES == 1 and mk.LAUNCHES == 1 and mk.PLAIN_LAUNCHES == 0,
          "render_rays_wave on the unpacked medium did not go through the dense trace_lanes_kernel")
    film_statistic(d_contrib, int(d_nc), film_d, int(nc_d), "render_rays_wave against render_wave, unpacked")
    dense = dict(wave_rep=wave_rep_d, wave_max_abs=wave_max_abs_d, lane_iters=lane_iters_d, trace_ms=trace_ms,
                 trace_bound=(t_bound_ms, t_bound_by), trace_launches=mk.DENSE_LAUNCHES,
                 step_max_abs=dense_step_max_abs)
    del film_d, sf_d, si_d, d_contrib
    # the unpacked main path (render -> tonemap -> PNG)
    _, dflag_rays_s, dncap, dflag_counts, _ = main_path(dflag, 2, os.path.join(OUT_DIR, "flagship_unpacked.png"),
                                                     "flagship unpacked", card)
    check(dncap == 0, f"{dncap} unpacked flagship rays truncated at the step cap")
    del film_k, film_p, film_dp, sf_k, si_k, sf_p, si_p, sf_dp, si_dp, dflag

    # ------------------------------------------------------------------
    phase("5 fire")
    del flag, flag_med, flag_dense
    torch.cuda.empty_cache()
    fire_cfg = loads_configuration(json.dumps(FIRE_SCENE))
    f_dens, f_temp = fire_plume(height=96, radius=28.0)
    f_temp_al = dense_grid_from_array(f_temp.data, f_temp.origin_ijk, f_temp.voxel_size, (0.0, 0.0, 0.0))
    fire_rays_s, fire_reps = {}, {}
    fire_film_8 = None
    for width, temp_grid in ((8, f_temp), (16, f_temp_al), ("unpacked", f_temp)):
        med = Medium.from_grids(f_dens, temp_grid, pack=width != "unpacked")
        label = "fire unpacked" if width == "unpacked" else f"fire {width}-wide rows"
        if width == "unpacked":
            check(med.density_rows is None and med.temperature_rows is None, "the unpacked fire medium has tables")
        else:
            check(med.density_rows.shape[1] == width, f"fire medium has {med.density_rows.shape[1]}-wide rows")
        sc = Scene.from_config(fire_cfg, med, max_iters=FIRE_MAX_ITERS)
        png = os.path.join(OUT_DIR, f"fire_{width}{'' if width == 'unpacked' else 'wide'}.png")
        render(sc, num_waves=1)  # warm-up: the blackbody table, first-call allocations
        times, fire_rays_s[width], _, _, _ = main_path(sc, 2, png, label, card)
        fire_reps[width] = wave_kernel_report(sc, label, card)
        if width == 16:
            profile_pass(sc, os.path.join(OUT_DIR, "fire_16wide_profiled.png"), min(times), "fire 16-wide")
        if width == 8:
            fire_film_8 = render_wave_image(sc, 1)
        if width == "unpacked":
            # The third emission arm (the dense temperature array through its
            # own transform) on one whole wave: against the plain version, and
            # against the 8-wide kernel, which reads the same corners from its
            # temperature rows through the same transform.
            fkw = wave_args(sc, 1)
            film_fk = torch.zeros((H, W, 4), dtype=torch.float32, device=dev)
            it_fk, nc_fk = mk.render_wave(film=film_fk, pixels=range(0, n), **fkw)
            film_fp = torch.zeros_like(film_fk)
            it_fp, nc_fp = mk.render_wave_plain(film=film_fp, pixels=range(0, n), **fkw)
            film_statistic(film_fk, int(nc_fk), film_fp, int(nc_fp),
                           f"render_wave fire wave, dense instantiation (longest lane {int(it_fk)} vs {int(it_fp)})")
            fire_same = bool(torch.equal(film_fk, fire_film_8))
            print(f"render_wave fire wave: dense film bitwise equal to the 8-wide kernel's {fire_same}")
            check(fire_same, "the dense emissive film differs from the 8-wide kernel's")
            check(float(film_fk[..., :3].max()) > 0, "the dense emissive film is black")
            del film_fk, film_fp
        del med, sc
    dense_beside_packed(fire_reps[8], fire_reps["unpacked"], "fire (8-wide rows)", card)
    del fire_film_8
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
    cloud_cfg = loads_configuration(json.dumps(cloud_cfg))
    cloud_scene = Scene.from_config(cloud_cfg, cloud_med, max_iters=FLAGSHIP_MAX_ITERS)
    png = os.path.join(OUT_DIR, "big_cloud_512.png")
    _, cloud_rays_s, _, _, _ = main_path(cloud_scene, 2, png, "big_cloud 512^3", card)
    peak = torch.cuda.max_memory_allocated()
    print(f"big_cloud 512^3: {'load from cache' if cached else 'generate'} {gen_s:.1f} s, medium "
          f"build {build_s:.2f} s, table {tuple(cloud_med.density_rows.shape)} = "
          f"{cloud_med.density_rows.numel() * 4 / 1e9:.2f} GB, peak device memory {peak / 1e9:.2f} GB")
    cloud_rep = wave_kernel_report(cloud_scene, "big_cloud 512^3", card)
    cloud_film = render_wave_image(cloud_scene, 1)  # for the dense kernel's film below
    del cloud_med, cloud_scene
    torch.cuda.empty_cache()

    # ---- the production-size file: written and read, C++ core and numpy ----
    # Host work, on the host's clock: the seconds say how long a user waits
    # for a scene to load, not what the card does.
    import contextlib
    import hashlib

    from volume_path_tracer_tpu_torch.grids import native, nvdb

    cloud_np = cloud.data.numpy()
    nvdb_path = os.path.join(OUT_DIR, "big_cloud_512.nvdb")
    check(native.available(), "the C++ core of the .nvdb I/O was not built (no g++?)")
    file_s, digests, read_back = {}, {}, {}
    for which in ("core", "numpy"):
        with native.numpy_only() if which == "numpy" else contextlib.nullcontext():
            t0 = time.perf_counter()
            nvdb.write_nvdb(nvdb_path, {"density": (cloud_np, cloud.origin_ijk, cloud.voxel_size, cloud.world_offset)})
            file_s[which, "write"] = time.perf_counter() - t0
            with open(nvdb_path, "rb") as f:
                digests[which] = hashlib.sha1(f.read()).hexdigest()
            t0 = time.perf_counter()
            read_back[which] = nvdb.read_nvdb(nvdb_path)["density"]
            file_s[which, "read"] = time.perf_counter() - t0
    g = read_back["core"]
    lo = [a - b for a, b in zip(g.origin_ijk, cloud.origin_ijk)]
    hi = [l + e for l, e in zip(lo, g.data.shape)]
    inside = cloud_np[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    n_active = int(np.count_nonzero(cloud_np))
    print(f"big_cloud 512^3 as .nvdb (host work): file {os.path.getsize(nvdb_path) / 1e6:.1f} MB, "
          f"{g.meta['node_count'][0]} leaves, {n_active} active voxels of {cloud_np.size}; write "
          f"{file_s['core', 'write']:.2f} s with the C++ core, {file_s['numpy', 'write']:.2f} s with numpy; read "
          f"{file_s['core', 'read']:.2f} s with the C++ core, {file_s['numpy', 'read']:.2f} s with numpy; files "
          f"bitwise equal {digests['core'] == digests['numpy']}; active box {tuple(g.data.shape)} at {g.origin_ijk}")
    check(digests["core"] == digests["numpy"], "the C++ core and the numpy path wrote different files")
    check(np.array_equal(g.data, read_back["numpy"].data) and g.origin_ijk == read_back["numpy"].origin_ijk,
          "the C++ core and the numpy path read different grids")
    check(np.array_equal(g.data, inside) and int(np.count_nonzero(inside)) == n_active,
          "the 512^3 grid read back differs from the grid written")
    check(g.voxel_size == cloud.voxel_size and tuple(g.world_offset) == tuple(cloud.world_offset),
          "the 512^3 grid's transform changed in the file")
    os.remove(nvdb_path)
    del read_back, g, inside, cloud_np

    # ---- the same cloud unpacked: 0.54 GB on the card instead of 4.33 GB ----
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cloud_dense = Medium.from_grids(cloud, pack=False)
    torch.cuda.synchronize()
    dense_build_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() - before
    dcloud_scene = Scene.from_config(cloud_cfg, cloud_dense, max_iters=FLAGSHIP_MAX_ITERS)
    _, dcloud_rays_s, dcloud_ncap, dcloud_counts, _ = main_path(
        dcloud_scene, 2, os.path.join(OUT_DIR, "big_cloud_512_unpacked.png"), "big_cloud 512^3 unpacked", card)
    check(dcloud_ncap == 0, f"{dcloud_ncap} unpacked 512^3 rays truncated at max_iters {FLAGSHIP_MAX_ITERS}")
    dpeak = torch.cuda.max_memory_allocated()
    dcloud_rep = wave_kernel_report(dcloud_scene, "big_cloud 512^3 unpacked", card)
    # One whole 512^3 wave by the dense kernel against the packed kernel's:
    # the same corners in the same order, bitwise.
    dcloud_film = render_wave_image(dcloud_scene, 1)
    cloud_same = bool(torch.equal(dcloud_film, cloud_film))
    print(f"big_cloud 512^3 unpacked: medium build {dense_build_s:.2f} s, density array "
          f"{cloud_dense.density.data.numel() * 4 / 1e9:.2f} GB, medium resident "
          f"{resident / 1e9:.2f} GB, peak device memory {dpeak / 1e9:.2f} GB "
          f"(packed: {peak / 1e9:.2f} GB); rays/s {dcloud_rays_s:.1f} (packed: {cloud_rays_s:.1f}); wave 1's dense "
          f"film bitwise equal to the packed kernel's {cloud_same} on {card}")
    check(cloud_same, "the dense wave kernel's 512^3 film differs from the packed kernel's")
    check(dpeak <= 1.9e9, f"the unpacked 512^3 render peaked at {dpeak / 1e9:.2f} GB of device memory, over 1.9 GB")
    dense_beside_packed(cloud_rep, dcloud_rep, "big_cloud 512^3", card)
    del cloud, cloud_dense, dcloud_scene, cloud_film, dcloud_film
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    phase("7 cli")
    from volume_path_tracer_tpu_torch import cli
    from volume_path_tracer_tpu_torch.io.png import read_png

    # Scenes as a user has them: a JSON whose volume_path names a .nvdb. The
    # grids are cut to their active boxes first, which is what a reader
    # returns, so the medium read back can be held bitwise to the one written
    # and the film to the film of the same medium built directly.
    nvdb_cells = [
        ("flagship", dict(WDAS_SCENE, num_waves=4), FLAGSHIP_MAX_ITERS,
         {"density": fog_sphere(radius=30.0, falloff=6.0)}),
        ("fire", dict(FIRE_SCENE, num_waves=2), FIRE_MAX_ITERS, dict(zip(("density", "temperature"), (f_dens, f_temp)))),
    ]
    nvdb_launches = 0
    for name, scene_cfg, max_iters, grids in nvdb_cells:
        written = {}
        for gname, g in grids.items():
            data, origin = crop_to_active(g)
            written[gname] = (data, origin, g.voxel_size, g.world_offset)
        vol_path = os.path.join(OUT_DIR, f"{name}.nvdb")
        nvdb.write_nvdb(vol_path, written)
        cfg_path = os.path.join(OUT_DIR, f"{name}_scene.json")
        with open(cfg_path, "w") as f:
            json.dump(dict(scene_cfg, volume_path=f"{name}.nvdb"), f)  # relative to the scene file
        png = os.path.join(OUT_DIR, f"cli_{name}_nvdb.png")
        ckpt = os.path.join(OUT_DIR, f"cli_{name}_nvdb.npz")
        for stale in (png, ckpt):
            if os.path.exists(stale):
                os.remove(stale)
        reset_launch_counts(mk)
        t0 = time.perf_counter()
        rc = cli.main([cfg_path, png, "--max-iters", str(max_iters), "--checkpoint", ckpt])
        cli_s = time.perf_counter() - t0
        launches, plain = mk.WAVE_LAUNCHES, mk.PLAIN_WAVE_LAUNCHES + mk.PLAIN_LAUNCHES
        nvdb_launches += launches
        check(rc == 0 and launches == scene_cfg["num_waves"] and plain == 0 and mk.DENSE_WAVE_LAUNCHES == 0,
              f"cli on {name}.nvdb: rc {rc}, {launches} wave launches, {plain} plain runs")
        med = nvdb.read_nvdb_medium(vol_path)
        for gname, got in (("density", med.density), ("temperature", med.temperature)):
            if gname not in written:
                check(got is None, f"{name}.nvdb: a {gname} grid appeared")
                continue
            data, origin, voxel, offset = written[gname]
            check(got.device.type == "cuda" and np.array_equal(got.data.cpu().numpy(), data),
                  f"{name}.nvdb: the {gname} array read back differs from the one written")
            check(got.origin_ijk == origin and got.voxel_size == voxel and got.world_offset == tuple(offset),
                  f"{name}.nvdb: the {gname} transform read back differs from the one written")
        direct = Medium.from_grids(*(dense_grid_from_array(*written[k]) for k in written))
        cfg_obj = loads_configuration(json.dumps(scene_cfg))
        film_direct = render(Scene.from_config(cfg_obj, direct, max_iters=max_iters))
        film_cli = torch.from_numpy(np.load(ckpt)["film"]).to(dev)
        img = read_png(png)
        same = bool(torch.equal(film_cli, film_direct))
        print(f"cli on {name}.nvdb ({os.path.getsize(vol_path) / 1e6:.2f} MB, density "
              f"{tuple(med.density.shape)}{', temperature ' + str(tuple(med.temperature.shape)) if med.has_temperature else ''}"
              f"): {W}x{H}x{scene_cfg['num_waves']} in {cli_s:.2f} s with load, build and PNG; {launches} "
              f"render_wave launches, no plain run; medium read back bitwise equal to the one written; film "
              f"bitwise equal to the direct build's {same}; image max {img.max()}")
        check(same, f"cli on {name}.nvdb: the film differs from the film of the medium built directly")
        check(bool(torch.isfinite(film_cli).all()) and bool((film_cli[..., 3] == scene_cfg["num_waves"]).all()),
              f"cli on {name}.nvdb: film not finite or wrong weights")
        check(img.shape == (H, W, 3) and img.max() > 0, f"cli on {name}.nvdb: image missing or black")
        del med, direct, film_direct, film_cli

    cli_cfg = dict(FIRE_SCENE, num_waves=4)
    cli_cfg["camera_parameters"] = dict(WDAS_SCENE["camera_parameters"],
                                        position=[120.0, 32.0, 0.0], look=[0.0, 32.0, 0.0])
    cfg_path = os.path.join(OUT_DIR, "fire_scene.json")
    with open(cfg_path, "w") as f:
        json.dump(cli_cfg, f)
    png = os.path.join(OUT_DIR, "cli_plume.png")
    if os.path.exists(png):
        os.remove(png)
    reset_launch_counts(mk)
    rc = cli.main([cfg_path, png, "--procedural", "plume", "--waves", "2"])
    img = read_png(png)
    print(f"cli: rc {rc}, {png} {img.shape} max {img.max()}, render_wave launches {mk.WAVE_LAUNCHES}, "
          f"plain launches {mk.PLAIN_WAVE_LAUNCHES} and {mk.PLAIN_LAUNCHES}")
    check(rc == 0 and img.shape == (H, W, 3) and img.max() > 0, "cli render failed or black")
    check(mk.WAVE_LAUNCHES > 0 and mk.PLAIN_WAVE_LAUNCHES == 0 and mk.PLAIN_LAUNCHES == 0,
          "cli render did not go through the wave kernel")

    # --profile: the trace is written and names the wave kernel. CUPTI now
    # and then hands a profiler session none of its kernel records (seen on
    # the H100: a trace with the host's events and no kernel, while the
    # launch counters show the kernel ran; kernel_device_ms takes such a
    # window again): a trace without the kernel is taken again, at most
    # three times in all, and every attempt is printed.
    prof_dir = os.path.join(OUT_DIR, "cli_profile")
    trace_path = os.path.join(prof_dir, "trace.json")
    for attempt in range(1, 4):
        if os.path.exists(trace_path):
            os.remove(trace_path)
        reset_launch_counts(mk)
        rc = cli.main([cfg_path, png, "--procedural", "plume", "--waves", "2", "--profile", prof_dir])
        check(rc == 0 and os.path.exists(trace_path), "cli --profile wrote no trace")
        check(mk.WAVE_LAUNCHES > 0, "cli --profile did not go through the wave kernel")
        with open(trace_path) as f:
            trace_text = f.read()
        named = trace_text.count("render_wave_kernel")
        print(f"cli --profile, attempt {attempt}: {trace_path} {len(trace_text) / 1e3:.1f} kB, names "
              f"render_wave_kernel {named} times ({mk.WAVE_LAUNCHES} launches), cudaLaunchKernel "
              f"{trace_text.count('cudaLaunchKernel')} times")
        if named:
            break
    check("render_wave_kernel" in trace_text, "the --profile trace does not name render_wave_kernel")
    del trace_text

    # ------------------------------------------------------------------
    phase("8 summary")
    print("kernels: " + json.dumps({
        "render_wave": flag_counts["render_wave"], "render_wave_plain": flag_counts["render_wave_plain"],
        "trace_lanes": trace_launches, "trace_lanes_plain": trace_plain,
        "render_wave_from_nvdb_scenes": nvdb_launches,
        "render_wave_dense": dflag_counts["render_wave_dense"] + dcloud_counts["render_wave_dense"],
        "trace_lanes_dense": dense["trace_launches"]}))
    print(f"flagship_rays_per_s {flag_rays_s:.1f} fire_8wide_rays_per_s {fire_rays_s[8]:.1f} "
          f"fire_16wide_rays_per_s {fire_rays_s[16]:.1f} big_cloud_512_rays_per_s {cloud_rays_s:.1f} "
          f"flagship_unpacked_rays_per_s {dflag_rays_s:.1f} fire_unpacked_rays_per_s "
          f"{fire_rays_s['unpacked']:.1f} big_cloud_512_unpacked_rays_per_s {dcloud_rays_s:.1f}")

    # ------------------------------------------------------------------
    phase("9 train")
    train_kernels = train_phase(card, dev)
    record_summary()

    # ------------------------------------------------------------------
    phase("10 mesh")
    sharded = mesh_phase(card, dev)
    for k in train_kernels:
        k["launches_sharded"] = sharded[{"record_lanes": "record", "replay_lanes": "replay"}.get(k["name"], k["name"])]

    # ------------------------------------------------------------------
    phase("11 bench")
    bench_launches = bench_phase(card, dev, nvcc_s, flag_render_rays_s)
    print(card)
    source = "volume_path_tracer_tpu_torch/csrc/trace_lanes.cu"
    replaces = "volume_path_tracer_tpu/render/megakernel.py:617"
    record = {"kernels": [
        # launches: the flagship main path's; launches_sharded: the sharded
        # path's (phase 10); lane_iters: the counting instantiation's count
        # of the flagship wave against the plain version's
        {"name": "render_wave", "route": "cuda", "source": source, "replaces": replaces,
         "launches": flag_counts["render_wave"],
         "launches_sharded": sharded["render_wave"], "max_abs_err": wave_max_abs, "ms": wave_rep["ms"],
         "plain_ms": wave_plain_ms, "bound_ms": wave_rep["bound_ms"], "bound_by": wave_rep["bound_by"],
         "library_ms": None, "lane_iters": wave_lane_iters[0], "lane_iters_plain": wave_lane_iters[1]},
        {"name": "trace_lanes", "route": "cuda", "source": source, "replaces": replaces,
         "launches": trace_launches, "max_abs_err": one_step_max_abs, "ms": kernel_ms,
         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None},
        # The dense instantiations of the same two kernels (a medium without
        # the fused table): launches on the unpacked main paths (the flagship
        # and the 512^3 render, the flagship ray batch); times, errors and
        # bounds on the flagship wave.
        {"name": "render_wave_dense", "route": "cuda", "source": source, "replaces": replaces,
         "launches": dflag_counts["render_wave_dense"] + dcloud_counts["render_wave_dense"],
         "launches_sharded": sharded["render_wave_dense"],
         "max_abs_err": dense["wave_max_abs"], "ms": dense["wave_rep"]["ms"],
         "plain_ms": dense_wave_plain_ms, "bound_ms": dense["wave_rep"]["bound_ms"],
         "bound_by": dense["wave_rep"]["bound_by"], "library_ms": None,
         "lane_iters": dense["lane_iters"][0], "lane_iters_plain": dense["lane_iters"][1]},
        {"name": "trace_lanes_dense", "route": "cuda", "source": source, "replaces": replaces,
         "launches": dense["trace_launches"], "max_abs_err": dense["step_max_abs"],
         "ms": dense["trace_ms"], "plain_ms": dense_plain_ms, "bound_ms": dense["trace_bound"][0],
         "bound_by": dense["trace_bound"][1], "library_ms": None},
        # The gradient path and the step's ray batch (phase 9): launches in
        # bench.py's three train cells, times and bounds on the full density
        # step.
        *train_kernels,
    ]}
    # launches_bench: each kernel's launches in the bench's primary (phase 11)
    for k in record["kernels"]:
        k["launches_bench"] = bench_launches[k["name"]]
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


# A measurement-only variant of the replay's scatter (its gradients are
# wrong by design; it never runs on the main path): scatter_grid's atomics
# into 8 floats of each warp's own (no scattered addresses; the grid must
# hold 8,192 voxels). --variants builds it from the source's text.
SCATTER_LINE = "    float* q = grid + (((ptrdiff_t)cx * Y + cy) * Z + iz);"
SCATTER_VARIANTS = {
    "scatter=one_place_per_warp": [(SCATTER_LINE, "    float* q = grid + ((((size_t)blockIdx.x * THREADS + "
                                                  "threadIdx.x) >> 5) & 1023) * 8 + 2 * p;")],
}
# Resident blocks a gradient kernel is compiled for (NAME=N: its
# __launch_bounds__ patched from MIN_BLOCKS to N; the record's only in its
# record instantiation, so the forward kernels keep theirs).
BOUNDS_VARIANTS = {
    "record_blocks": ("__launch_bounds__(THREADS, MIN_BLOCKS) trace_lanes_kernel",
                      "__launch_bounds__(THREADS, kRecord ? {n} : MIN_BLOCKS) trace_lanes_kernel"),
    "replay_blocks": ("__launch_bounds__(THREADS, MIN_BLOCKS) replay_lanes_kernel",
                      "__launch_bounds__(THREADS, {n}) replay_lanes_kernel"),
}


def variant_sources(specs, text, original, var_dir):
    """[(name, path)] of the sources --variants times: the source itself,
    then one per SPEC (see variants())."""
    import re

    sources = [("source", original)]
    for spec in specs:
        if os.path.isfile(spec):
            sources.append((os.path.basename(spec), os.path.abspath(spec)))
            continue
        changed = text
        if spec in SCATTER_VARIANTS:
            for old, new in SCATTER_VARIANTS[spec]:
                check(changed.count(old) == 1, f"{spec}: the lines it changes are not in {original}")
                changed = changed.replace(old, new)
        else:
            for item in spec.split(","):
                name, value = item.split("=")
                if name in BOUNDS_VARIANTS:
                    old, new = BOUNDS_VARIANTS[name]
                    check(changed.count(old) == 1, f"{spec}: `{old}` is not in {original}")
                    changed = changed.replace(old, new.format(n=int(value)))
                    continue
                changed, n_sub = re.subn(rf"(constexpr int {name} = )\w+;", rf"\g<1>{int(value)};", changed)
                check(n_sub == 1, f"no `constexpr int {name} = ...;` in {original}")
        path = os.path.join(var_dir, spec.replace("=", "_").replace(",", "__") + ".cu")
        with open(path, "w") as f:
            f.write(changed)
        sources.append((spec, path))
    return sources


def variants(specs):
    """python3 chip_smoke.py --variants SPEC [SPEC ...]

    Times variants of the kernel source against csrc/trace_lanes.cu in turns
    within one process (source, variants, variants reversed, source), so
    that two versions of the source are compared on one card, on the same
    media. SPEC is the path of a .cu file with the same C interface and
    array forms (a variant written elsewhere; to compare commits, whose
    media may differ, use --compare), NAME=VALUE[,NAME=VALUE...] for a copy
    of the source with those `constexpr int NAME = ...;` lines changed (or,
    for a NAME of BOUNDS_VARIANTS, that kernel's __launch_bounds__), or one
    of SCATTER_VARIANTS. All sources are built first, one nvcc each, all at
    once. Each turn prints the registers and spills of the production
    kernels; the cells of wave_cells side by side (time_wave_cells), with
    each film against the source's; and on bench.py's density step the
    record and replay kernels (the replay in the longest-first order),
    packed and dense, with each lane's replayed <g, L> and the gradient
    against the source's. Then one JSON line a turn.
    """
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from volume_path_tracer_tpu_torch.diff import inverse as inv
    from volume_path_tracer_tpu_torch.render import megakernel as mk

    check(torch.cuda.is_available(), "CUDA is not available")
    dev = torch.device("cuda", 0)
    card = gpu_name_and_limit()
    print(card)
    original = mk.SOURCE
    with open(original) as f:
        text = f.read()
    var_dir = os.path.join(mk.BUILD_DIR, "variants")
    os.makedirs(var_dir, exist_ok=True)
    sources = variant_sources(specs, text, original, var_dir)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip((n for n, _ in sources), pool.map(mk.build, [p for _, p in sources])))
    print(f"built {len(sources)} sources at once in {time.perf_counter() - t0:.2f} s", flush=True)

    cells = wave_cells(dev)
    med, fog_base, wdas, _, _, _, rays = density_step(dev)
    dense_med = inv.medium_with_params(fog_base, inv.OptimizableGrids(inv.param_from_density(
        fog_base.density.data)), pack=False)
    print(f"cells ready at {time.perf_counter() - T_START:.1f} s", flush=True)

    n_step = rays[2].shape[0]
    g_step = torch.tensor(np.random.default_rng(2).uniform(0.2, 1.0, (n_step, 3)), dtype=torch.float32, device=dev)
    film_reference, grad_reference = {}, {}
    for turn, (name, path) in enumerate(sources + sources[::-1]):
        mk.SOURCE, mk._lib = path, None
        mk._library()
        with open(libs[name] + ".log") as f:
            report = ptxas_report(f.read())
        regs = {k: v for k, v in report.items() if k.startswith(("render_wave_kernel<false", "trace_lanes_kernel<false",
                                                                 "replay_lanes_kernel<false"))}
        print(f"variant {name} (turn {turn + 1}): registers, spill store and load bytes "
              + ", ".join(f"{k} {v[0]} / {v[1]} / {v[2]}" for k, v in regs.items()), flush=True)
        summary, films = time_wave_cells(cells, card, f"variant {name}")
        for key, film in films.items():
            film_reference.setdefault(key, film)
        same = {f"{cell} {'packed' if pack else 'dense'}": bool(torch.equal(f, film_reference[cell, pack]))
                for (cell, pack), f in films.items()}
        print(f"variant {name}: films bitwise equal to the source's {json.dumps(same)}", flush=True)
        del films
        # the gradient kernels on bench.py's density step, packed and dense
        for layout, m in (("packed", med), ("dense", dense_med)):
            args = (m, wdas, None, *rays)
            L, tf, ctr = mk.record_lanes(*args, 16)
            order = mk.longest_first(ctr)
            _, _, acc, _ = mk.replay_lanes(*args, L, g_step, tf=tf, order=order, with_check=True)
            dd = mk.replay_lanes(*args, L, g_step, tf=tf, order=order)[0]
            ref = grad_reference.setdefault(layout, (acc, dd))
            rec_ms = kernel_device_ms(lambda: mk.record_lanes(*args, 16), 5, "trace_lanes_kernel")
            rep_ms = kernel_device_ms(lambda: mk.replay_lanes(*args, L, g_step, tf=tf, order=order), 5,
                                      "replay_lanes_kernel")
            print(f"variant {name}, density step {layout}: record {rec_ms:.4f} ms, replay {rep_ms:.4f} ms (longest group "
                  f"first); replayed <g, L> bitwise equal to the source's {bool(torch.equal(acc, ref[0]))}, gradient "
                  f"relative L2 against the source's {rel_l2(dd, ref[1]):.2e} on {card}", flush=True)
            summary[f"density step {layout}"] = {"record_ms": rec_ms, "replay_ms": rep_ms}
        print("variants: " + json.dumps({"turn": turn + 1, "variant": name, **summary}), flush=True)
    mk.SOURCE, mk._lib = original, None
    record_summary()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--variants"]:
        sys.exit(variants(sys.argv[2:]))
    if sys.argv[1:2] == ["--compare"]:
        sys.exit(compare(sys.argv[2] if len(sys.argv) > 2 else REPO))
    if sys.argv[1:2] == ["--phase"]:
        sys.exit(main(only=sys.argv[2]) if sys.argv[2:] in (["9"], ["10"], ["11"]) else 2)
    sys.exit(main())
