"""The port's bench (volume_path_tracer_tpu_torch/bench.py) held to the root
bench.py (the JAX package's benchmark), on the CPU at small sizes.

- (a) the transport parameters field by field, VPT_BENCH_SUPER_TAU included;
- (b) the flagship, fire and 512^3 cameras: rays within 1e-6 on a few pixels;
- (c) one wave of a 32x32 flagship camera (2 waves, max_iters 256) against
  bench.py's wave function over the XLA loop: more than 95% of lanes close
  at rtol 1e-4, atol 1e-5, channel means within 5%, equal n_capped;
- (d) the plain-against-kernel gates (bench.agreement) on seeded arrays;
- (e) the primary, --full's train cells and --render1024's CLI path at a
  tiny size: the documented keys with finite values, the files under OUT;
- (f) a tiny --cpu run writes under --out alone and leaves bench.py and
  every BENCH_*.json as they were;
- (g) without --cpu and without CUDA the bench raises before any work.

The root bench.py is loaded with importlib; it imports JAX only inside its
functions.
"""
import dataclasses
import glob
import hashlib
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_path_tracer_tpu.grids.procedural import fog_sphere as j_fog_sphere
from volume_path_tracer_tpu.models.medium import Medium as JMedium
from volume_path_tracer_tpu.render.integrator import trace_rays as j_trace_rays
from volume_path_tracer_tpu_torch import bench
from volume_path_tracer_tpu_torch.render import megakernel as mk

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# Every bench function at a size the CPU runs in seconds.
TINY = {
    "primary": dict(size=16, waves=2, reps=1),
    "big_cloud": dict(size=8, waves=1, reps=1, n=32),
    "fire": dict(size=8, waves=1, reps=1, sweep=(32, 64), low_iters=32),
    "train": dict(size=8, k=2, n_iters=64, chain=1, chains=1),
    "verify": dict(size=16, timed_waves=1, reps=1, compared_waves=2, fire_iters=64),
    "render1024": dict(size=16, waves=2, chunk=128),
}
PRIMARY_KEYS = {"metric", "value", "unit", "method", "pass_times_s", "device", "build_s"}


@pytest.fixture(scope="module")
def root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("which, max_iters", [
    ("wdas", 4096), ("wdas", 1024), ("fire", 2048), ("fire", 4096), ("fire", 8192),
])
def test_params_match_bench_py(root_bench, which, max_iters):
    name = f"_{which}_params"
    port = getattr(bench, name)(max_iters=max_iters)
    ref = getattr(root_bench, name)(max_iters=max_iters)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_super_tau_from_the_environment(root_bench, monkeypatch):
    monkeypatch.setenv("VPT_BENCH_SUPER_TAU", "3.25")
    port, ref = bench._wdas_params(), root_bench._wdas_params()
    assert port.super_tau == ref.super_tau == 3.25
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("cell", ["flagship", "fire", "big_cloud_512"])
def test_cameras_match_bench_py(root_bench, cell):
    size = 256
    if cell == "flagship":
        port = bench._flagship(CPU, size)[1]
        ref = root_bench._camera(size, size, (110.0, 0.0, 0.0))
    elif cell == "fire":
        port = bench._fire_camera(size, CPU)
        ref = root_bench._camera(size, size, (170.0, 48.0, 0.0), look=(0.0, 48.0, 0.0), vfov=37.0)
    else:
        port = bench._camera(size, size, (900.0, 0.0, 0.0), vfov=40.0, device=CPU)
        ref = root_bench._camera(size, size, (900.0, 0.0, 0.0), vfov=40.0)
    raster = np.array([[0, 0], [255, 0], [17, 200], [128, 128], [255, 255]], np.int32)
    jitter = np.random.default_rng(0).uniform(0.0, 0.5, (5, 2)).astype(np.float32)
    o, d = port.generate_rays(torch.from_numpy(raster), torch.from_numpy(jitter))
    jo, jd = ref.generate_rays(jnp.asarray(raster), jnp.asarray(jitter))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    assert port.imaging_ratio == ref.imaging_ratio


def test_one_wave_matches_bench_py(root_bench):
    W = H = 32
    params = bench._wdas_params(max_iters=256)
    medium, camera = bench._flagship(CPU, W)
    wave = root_bench._make_wave_fn(j_trace_rays, root_bench._wdas_params(max_iters=256))
    j_medium = JMedium.from_grids(j_fog_sphere(radius=30.0, falloff=6.0))
    j_camera = root_bench._camera(W, H, (110.0, 0.0, 0.0))
    ys, xs = np.mgrid[0:H, 0:W]
    raster = jnp.asarray(np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32))
    pids = jnp.arange(W * H, dtype=jnp.int32)
    for w in (1, 2):
        L, n_capped = bench.wave_radiance(mk.render_wave, medium, camera, params, W, H, w=w)
        jL, _, j_capped = wave(j_medium, j_camera, raster, pids, jnp.asarray([bench.SEED, w], jnp.uint32))
        jL = np.asarray(jL)
        close = np.isclose(L, jL, rtol=1e-4, atol=1e-5).all(-1).mean()
        assert close > 0.95, (w, close)
        rel = np.abs(L.mean(0) - jL.mean(0)) / np.abs(jL.mean(0))
        assert (rel < 0.05).all(), (w, rel)
        assert n_capped == int(j_capped)


def _pool(seed=0, n=4096):
    """Eight seeded waves of n lanes: (wave 1, the 8-wave mean, the pooled
    per-channel range lo, hi, all waves)."""
    waves = np.random.default_rng(seed).uniform(0.0, 1.0, (8, n, 3)).astype(np.float32)
    return waves[0], waves.mean(0), waves.min((0, 1)), waves.max((0, 1)), waves


@pytest.mark.parametrize("case", ["identical", "flip_inside", "lane_outside", "mean_bias"])
def test_agreement_gates(case):
    a, mean, lo, hi, waves = _pool()
    b, bm = a.copy(), mean.copy()
    if case == "identical":
        out = bench.agreement(a, b, mean, bm, lo, hi)
        assert out["lane_bitwise_fraction"] == out["lane_close_fraction"] == 1.0
        assert out["mean_rel_diff"] == 0.0
        return
    if case == "flip_inside":
        # a knife-edge flip re-rolls one lane's sample: another sample of the pool
        b[7] = waves[3, 7]
        bm[7] += (b[7] - a[7]) / 8
        out = bench.agreement(a, b, mean, bm, lo, hi)
        assert out["lane_close_fraction"] == round(1 - 1 / a.shape[0], 4)
        assert out["disagree_within_sample_range"] is True
        return
    if case == "lane_outside":
        b[7] = hi + 0.01  # the slack is 1e-5 + 1e-3 * (hi - lo)
        with pytest.raises(bench.GateFailed, match="outside per-sample range"):
            bench.agreement(a, b, mean, bm, lo, hi)
        return
    bm = mean * np.float32(1 + 2e-3)
    with pytest.raises(bench.GateFailed, match="mean mismatch"):
        bench.agreement(a, b, mean, bm, lo, hi)


def test_primary_tiny():
    before = mk.PLAIN_WAVE_LAUNCHES
    res = bench.bench_primary(CPU, **TINY["primary"])
    assert mk.PLAIN_WAVE_LAUNCHES - before == 2 * 2  # 2 waves, warm-up + 1 timed pass
    line = bench.primary_line(res, bench.card(CPU), None, waves=2, reps=1)
    assert set(line) == PRIMARY_KEYS
    assert line["unit"] == "rays/s/GPU" and line["metric"] == bench.METRIC
    assert np.isfinite(line["value"]) and line["value"] > 0 and len(line["pass_times_s"]) == 1
    assert line["device"] == {"name": "cpu", "power_limit": None}
    film = res.film.numpy()
    assert film.shape == (16, 16, 4) and np.isfinite(film).all() and (film[..., 3] == 2).all()
    assert film[..., :3].max() > 0 and res.n_capped == 0


def test_full_train_cells_tiny():
    out = {"peak_mem_gb": {}}
    bench.bench_train(out, CPU, **TINY["train"])
    for key in ("train_fwd_bwd_rays_per_s", "train_joint_emissive_rays_per_s"):
        assert np.isfinite(out[key]) and out[key] > 0, key
    assert out["train_method"] == "2 spp/step, best-of-1 chains of 1 device-resident steps, one forced transfer per chain"
    assert out["peak_mem_gb"] == {"train_fwd_bwd": None, "train_joint_emissive": None}


def test_render1024_cli_path_tiny(tmp_path):
    rec = bench.bench_render1024(str(tmp_path), CPU, **TINY["render1024"])
    assert set(rec) == {"render_1024_wall_s", "render_1024_rays_per_s", "render_1024_warm_wall_s",
                        "render_1024_warm_rays_per_s", "render_1024_waves", "render_1024_peak_hbm_mb",
                        "render_1024_method"}
    for key in ("render_1024_wall_s", "render_1024_rays_per_s", "render_1024_warm_wall_s",
                "render_1024_warm_rays_per_s"):
        assert np.isfinite(rec[key]) and rec[key] > 0, key
    assert rec["render_1024_waves"] == 2 and rec["render_1024_peak_hbm_mb"] is None
    d = tmp_path / "render1024"
    assert sorted(os.listdir(d)) == ["ck.npz", "out.png", "preview.png", "scene1024.json"]
    assert (np.load(d / "ck.npz")["film"][..., 3] == 2).all()


def _digests():
    paths = sorted(glob.glob(os.path.join(REPO, "BENCH_*.json"))) + [os.path.join(REPO, "bench.py")]
    out = {}
    for p in paths:
        with open(p, "rb") as f:
            out[p] = hashlib.sha1(f.read()).hexdigest()
    return out


def _root_entries():
    """The repository root's entries, less bytecode caches and hidden ones
    (which imports and test runners make)."""
    return sorted(x for x in os.listdir(REPO) if x != "__pycache__" and not x.startswith("."))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_cpu_run_writes_under_out_only(tmp_path, monkeypatch, capsys):
    out, cwd = tmp_path / "out", tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    before, root_before = _digests(), _root_entries()
    assert len(before) >= 2
    for mode in (["--full"], ["--verify"], ["--render1024"]):
        assert bench.main(["--cpu", "--out", str(out), *mode], sizes=TINY) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert _digests() == before
    assert _root_entries() == root_before and os.listdir(cwd) == []
    assert _files(out) == ["bench_extra.json", "bench_verify.json", "big_cloud_32.npy", "render1024/ck.npz",
                           "render1024/out.png", "render1024/preview.png", "render1024/scene1024.json"]
    primary = lines[1]  # --full prints its record, then the primary's line
    assert set(primary) == PRIMARY_KEYS
    with open(out / "bench_extra.json") as f:
        extra = json.load(f)
    # --render1024's keys merged over --full's
    assert "render_1024_wall_s" in extra and extra["primary_rays_per_s"] == primary["value"]
    for key in ("big_cloud_32_packed_rays_per_s", "big_cloud_32_raw_rays_per_s", "fire_rays_per_s",
                "fire_aligned_fused_rays_per_s", "fire_lowscattering_rays_per_s", "train_fwd_bwd_rays_per_s",
                "train_joint_emissive_rays_per_s"):
        assert np.isfinite(extra[key]) and extra[key] > 0, key
    assert set(extra["fire_max_iters_sweep"]) == {"32", "64"}
    with open(out / "bench_verify.json") as f:
        verify = json.load(f)
    assert verify["lane_close_fraction"] == verify["fire_lane_close_fraction"] == 1.0


def test_raises_without_cuda_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = (mk.PLAIN_WAVE_LAUNCHES, mk.WAVE_LAUNCHES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--out", str(tmp_path / "out")], sizes=TINY)
    assert (mk.PLAIN_WAVE_LAUNCHES, mk.WAVE_LAUNCHES) == before
    assert os.listdir(tmp_path) == []
