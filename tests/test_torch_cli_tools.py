"""The port's CLI on real scene files, its live preview, profiler and debug tools, on the CPU.

- cli.main --cpu on a scene JSON whose volume_path names a file written by
  write_nvdb (by the port and by the JAX package): the image equals, byte
  for byte, the render of the same medium built directly;
- io/term.py: the cases of tests/test_term_preview.py for the port's copy,
  and its painted bytes against the JAX module's on the same image;
- --live on a fake TTY paints frames, off a TTY warns and renders; the
  device downsample (bilinear, antialiased) against jax.image.resize(...,
  "linear") on the same image: within 1 u8 level (both are triangle filters
  widened by the shrink factor; the float results may differ in last bits and
  are truncated to u8, so a value at an integer boundary can show as one
  level; found on the three cases here, integer and fractional shrink
  factors: no pixel differs);
- --profile DIR writes a chrome trace; --cpu --mesh 2 (two cells on the
  CPU) writes the PNG of --mesh 1 byte for byte, --mesh 0 is fatal;
- make_step(collect_debug=True): the JAX step's keys, and values equal on one
  mid-flight state at the step's tolerance (rtol=1e-5, atol=1e-6 on more
  than 99% of lanes, tests/test_torch_integrator.py), and the default path
  returns the bare state;
- majorant_segments, dda_trace and trace_path_events against the JAX tools
  on the same ray: segments and rows equal (the walks are float64 numpy over
  bitwise equal tables), event kinds equal, radiance within the step's
  tolerance; the CSV headers are the reference's;
- visualize_ray writes a PNG through its main.
"""
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_path_tracer_tpu.grids import nvdb as jnvdb
from volume_path_tracer_tpu.grids import procedural as jproc
from volume_path_tracer_tpu.io import term as jterm
from volume_path_tracer_tpu.models.medium import Medium as JMedium
from volume_path_tracer_tpu.render import integrator as jint
from volume_path_tracer_tpu.tools import trace as jtrace
from volume_path_tracer_tpu.utils import rng as jrng
from volume_path_tracer_tpu_torch import cli
from volume_path_tracer_tpu_torch.grids import nvdb as tnvdb
from volume_path_tracer_tpu_torch.grids import procedural as tproc
from volume_path_tracer_tpu_torch.io import term as tterm
from volume_path_tracer_tpu_torch.io.png import read_png
from volume_path_tracer_tpu_torch.models.medium import Medium, medium_from_numpy
from volume_path_tracer_tpu_torch.render import integrator as tint
from volume_path_tracer_tpu_torch.render.renderer import Scene, render
from volume_path_tracer_tpu_torch.tools import trace as ttrace
from volume_path_tracer_tpu_torch.utils.color import film_to_srgb_u8
from volume_path_tracer_tpu_torch.utils.config import loads_configuration

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENE = {
    "output_size": [24, 16],
    "worker_parameters": {
        "single_pixel": {"enabled": True, "coord": [12, 8]},
        "infinite_light": {"xyz": [0.25, 0.25, 0.5], "multiplier": 2},
        "distant_light": {"xyz": [0.95, 1.0, 1.09], "multiplier": 5, "inv_direction": [0.5, 1, 0]},
        "use_jitter": True, "max_depth": 40,
    },
    "volume_parameters": {
        "sigma_s": 0.2, "sigma_a": 0.05, "henyey_greenstein_g": 0.3,
        "le_scale": 0.0, "temperature_offset": 300.0, "temperature_scale": 40.0,
    },
    "seed": 7, "tile_size": [8, 8], "num_waves": 2, "num_workers": 1,
    "volume_path": "vol.nvdb",
    "camera_parameters": {"position": [70, 0, 0], "look": [0, 0, 0], "up": [0, 1, 0],
                          "vfov_deg": 35, "imaging_ratio": 0.1},
}
FULL_FRAME = dict(SCENE, worker_parameters=dict(SCENE["worker_parameters"],
                                                single_pixel={"enabled": False, "coord": [0, 0]}))


def _write_scene(tmp_path, scene=FULL_FRAME, writer=tnvdb.write_nvdb, grids=None):
    """scene.json and the vol.nvdb it names, in tmp_path; returns the JSON's path."""
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(scene))
    if grids is None:
        g = tproc.fog_sphere(radius=12.0)
        grids = {"density": (g.data.numpy(), g.origin_ijk, g.voxel_size, g.world_offset)}
    writer(str(tmp_path / "vol.nvdb"), grids)
    return str(p)


def _direct_image(medium, scene=FULL_FRAME):
    sc = Scene.from_config(loads_configuration(json.dumps(scene)), medium, device="cpu")
    return film_to_srgb_u8(render(sc, device="cpu")).numpy()


@pytest.mark.parametrize("writer", [tnvdb.write_nvdb, jnvdb.write_nvdb], ids=["port_writer", "jax_writer"])
def test_cli_renders_a_scene_from_its_nvdb_file(tmp_path, writer):
    out = tmp_path / "out.png"
    rc = cli.main([_write_scene(tmp_path, writer=writer), str(out), "--cpu"])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape == (16, 24, 3) and img.max() > 0
    direct = _direct_image(Medium.from_grids(tproc.fog_sphere(radius=12.0), device="cpu"))
    np.testing.assert_array_equal(img, direct)


def test_cli_renders_an_emissive_scene_from_its_nvdb_file(tmp_path):
    d, t = tproc.fire_plume(height=24, radius=6.0)
    grids = {"density": (d.data.numpy(), d.origin_ijk, d.voxel_size, d.world_offset),
             "temperature": (t.data.numpy(), t.origin_ijk, t.voxel_size, t.world_offset)}
    scene = dict(FULL_FRAME, volume_parameters=dict(
        FULL_FRAME["volume_parameters"], sigma_s=0.9, sigma_a=2.0, le_scale=4e-8, temperature_scale=43.0))
    scene["camera_parameters"] = dict(FULL_FRAME["camera_parameters"], position=[50, 12, 0], look=[0, 12, 0])
    out = tmp_path / "out.png"
    assert cli.main([_write_scene(tmp_path, scene, grids=grids), str(out), "--cpu", "--waves", "1"]) == 0
    lit = _direct_image(Medium.from_grids(d, t, device="cpu"), dict(scene, num_waves=1))
    np.testing.assert_array_equal(read_png(str(out)), lit)
    dark = _direct_image(Medium.from_grids(d, device="cpu"), dict(scene, num_waves=1))
    assert not np.array_equal(lit, dark)  # the temperature grid was read and emits


# ------------------------------------------------------------- io/term.py


class _FakeTTY(io.StringIO):
    def isatty(self):
        return True


def test_downsample_box_average_preserves_mean():
    img = (np.random.default_rng(0).uniform(0, 255, (64, 96, 3))).astype(np.uint8)
    small = tterm._downsample(img, 48, 32)
    assert small.shape == (32, 48, 3)
    assert abs(float(small.mean()) - float(img.mean())) < 3.0
    np.testing.assert_array_equal(small, jterm._downsample(img, 48, 32))


def test_ansi_truecolor_halfblocks_and_inplace_repaint():
    img = (np.random.default_rng(1).uniform(0, 255, (32, 48, 3))).astype(np.uint8)
    s, js = _FakeTTY(), _FakeTTY()
    tp, jp = tterm.TermPreview(max_cols=40, stream=s), jterm.TermPreview(max_cols=40, stream=js)
    tp.draw(img, "[vpt] 50%")
    jp.draw(img, "[vpt] 50%")
    out1 = s.getvalue()
    assert "\x1b[38;2;" in out1 and "▀" in out1 and "[vpt] 50%" in out1
    tp.draw(img, "[vpt] 100%")
    jp.draw(img, "[vpt] 100%")
    out2 = s.getvalue()[len(out1):]
    # second frame repaints over the first: starts with a cursor-up sequence
    assert out2.startswith("\x1b[") and "A" in out2[:6]
    assert s.getvalue() == js.getvalue()  # the same bytes as the JAX module paints


def test_non_tty_is_noop():
    s = io.StringIO()
    tp = tterm.TermPreview(stream=s)
    tp.draw(np.zeros((8, 8, 3), np.uint8))
    assert s.getvalue() == "" and not tp.enabled


def test_geometry_contract_and_presmall_passthrough():
    s = _FakeTTY()
    tp = tterm.TermPreview(max_cols=40, stream=s)
    out_h, out_w = tp.geometry(1024, 1024)
    assert (out_h, out_w) == jterm.TermPreview(max_cols=40, stream=_FakeTTY()).geometry(1024, 1024)
    assert out_w <= 40 and out_h % 2 == 0 and out_h >= 2
    assert abs(out_h - out_w) <= 2
    small = (np.random.default_rng(2).uniform(0, 255, (out_h, out_w, 3))).astype(np.uint8)
    tp.draw(small, "pre-small")
    txt = s.getvalue()
    assert "\x1b[38;2;" in txt and "pre-small" in txt
    r, g, b = (int(v) for v in small[0, 0])
    assert f"\x1b[38;2;{r};{g};{b}m" in txt  # exact passthrough
    tp.finish()
    tp.draw(small)
    assert s.getvalue()[len(txt):].startswith("\r")  # after finish() the next frame starts afresh, no cursor-up


@pytest.mark.parametrize("shape, small", [((64, 96), (32, 48)), ((1024, 1024), (40, 40)), ((270, 480), (44, 80))])
def test_device_downsample_matches_jax_image_resize(shape, small):
    rng = np.random.default_rng(3)
    # a smooth image with a hard edge and noise: what a partly rendered film looks like
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    img = 127 + 100 * np.sin(x / 17.0)[..., None] * np.cos(y / 23.0)[..., None] + rng.normal(0, 20, (*shape, 3))
    img[:, shape[1] // 3:shape[1] // 3 + 5] = 255
    img = np.clip(img, 0, 255).astype(np.uint8)
    got = cli.downsample_srgb_u8(torch.from_numpy(img), *small).numpy()
    ref = jax.image.resize(jnp.asarray(img).astype(jnp.float32), (*small, 3), "linear")
    ref = np.asarray(jnp.clip(ref, 0, 255).astype(jnp.uint8))
    assert got.shape == ref.shape == (*small, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.01


# ------------------------------------------------------------ CLI options


def test_live_on_a_fake_tty_paints_each_wave_and_chunk(tmp_path, monkeypatch):
    tty = _FakeTTY()
    monkeypatch.setattr(sys, "stdout", tty)
    out = tmp_path / "out.png"
    rc = cli.main([_write_scene(tmp_path), str(out), "--cpu", "--live", "--chunk-pixels", "128"])
    monkeypatch.undo()
    assert rc == 0
    txt = tty.getvalue()
    assert txt.count("▀") > 0 and "\x1b[38;2;" in txt
    assert "M rays/s" in txt  # the wave's status line under the picture
    assert txt.count("\x1b[J") >= 2  # one frame per wave at least
    np.testing.assert_array_equal(
        read_png(str(out)), _direct_image(Medium.from_grids(tproc.fog_sphere(radius=12.0), device="cpu")))


def test_live_off_a_tty_warns_and_renders(tmp_path, capsys):
    out = tmp_path / "out.png"
    assert cli.main([_write_scene(tmp_path), str(out), "--cpu", "--live", "--waves", "1"]) == 0
    cap = capsys.readouterr()
    assert "--live requires a TTY" in cap.err and "▀" not in cap.out
    assert read_png(str(out)).max() > 0


def test_profile_writes_a_trace(tmp_path, capsys):
    prof_dir = tmp_path / "prof"
    out = tmp_path / "out.png"
    rc = cli.main([_write_scene(tmp_path), str(out), "--cpu", "--waves", "1", "--profile", str(prof_dir)])
    assert rc == 0
    trace = prof_dir / "trace.json"
    assert trace.exists()
    events = json.loads(trace.read_text())["traceEvents"]
    assert len(events) > 10
    assert "profiler trace written to" in capsys.readouterr().err
    assert read_png(str(out)).max() > 0


def test_profile_trace_covers_set_up_and_waves(tmp_path):
    """The profiler starts before the medium loads: the trace holds the
    build's span and each wave's, on a mesh the sharded wave's too."""
    for extra, wave in (([], "render.wave"), (["--mesh", "2"], "shard.wave")):
        prof_dir = tmp_path / ("prof" + "".join(extra))
        rc = cli.main([_write_scene(tmp_path), str(tmp_path / "out.png"), "--cpu", "--waves", "2",
                       "--profile", str(prof_dir), *extra])
        assert rc == 0
        events = json.loads((prof_dir / "trace.json").read_text())["traceEvents"]
        starts = {}
        for e in events:
            starts.setdefault(e.get("name"), []).append(float(e.get("ts", 0)))
        assert len(starts.get("medium.build", [])) == 1 and len(starts.get(wave, [])) == 2
        assert starts["medium.build"][0] < min(starts[wave])


def test_mesh_1_renders_and_mesh_2_is_fatal(tmp_path, capsys):
    """--mesh 2 shards the waves over two CPU cells: the PNG is --mesh 1's,
    byte for byte; --mesh 0 stays fatal."""
    cfg = _write_scene(tmp_path)
    out1, out2 = tmp_path / "out1.png", tmp_path / "out2.png"
    assert cli.main([cfg, str(out1), "--cpu", "--mesh", "1", "--waves", "2"]) == 0
    assert cli.main([cfg, str(out2), "--cpu", "--mesh", "2", "--waves", "2"]) == 0
    assert "sharding rays over {'rays': 2, 'spp': 1} cells" in capsys.readouterr().err
    assert out1.read_bytes() == out2.read_bytes()
    with pytest.raises(SystemExit) as e:
        cli.main([cfg, str(tmp_path / "no.png"), "--cpu", "--mesh", "0"])
    assert e.value.code == 1
    assert "the device count must be at least 1" in capsys.readouterr().err
    assert not (tmp_path / "no.png").exists()


def test_chunk_preview_is_throttled_after_the_work(tmp_path, monkeypatch):
    """--preview with --chunk-pixels on a clock that moves 0.15 s a reading:
    the first chunk boundary writes the preview, the 5 FPS cap skips
    boundaries that come sooner than 0.2 s after the last paint, and the 2 s
    preview throttle (its stamp taken after the write) lets no second preview
    through in this short render."""
    import time as real_time
    import types

    from volume_path_tracer_tpu_torch.io import png as tpng

    ticks = iter(range(10**6))
    clock = types.SimpleNamespace(monotonic=lambda: 1000.0 + 0.15 * next(ticks),
                                  perf_counter=real_time.perf_counter)
    monkeypatch.setattr(cli, "time", clock)
    prev = tmp_path / "prev.png"
    writes = []
    real = tpng.write_png

    def counting(path, img, atomic=False):
        writes.append((path, atomic))
        return real(path, img, atomic=atomic)

    monkeypatch.setattr(tpng, "write_png", counting)
    rc = cli.main([_write_scene(tmp_path), str(tmp_path / "out.png"), "--cpu", "--waves", "1",
                   "--chunk-pixels", "64", "--preview", str(prev)])
    assert rc == 0 and prev.exists()
    assert writes == [(str(prev), True), (str(tmp_path / "out.png"), False)]


# ---------------------------------------------------------- debug channel

PARAMS = dict(
    sigma_a=0.1, sigma_s=0.4, hg_g=0.3, le_scale=0.0,
    temperature_offset=300.0, temperature_scale=40.0,
    infinite_xyz=(0.25, 0.25, 0.5), infinite_multiplier=1.0,
    distant_xyz=(0.95, 1.0, 1.09), distant_multiplier=3.0,
    distant_inv_direction=(0.5, 1.0, 0.0), max_depth=40, max_iters=2048,
)


def _media(radius=10.0, pack=True):
    jg = jproc.fog_sphere(radius=radius)
    return JMedium.from_grids(jg, pack=pack), medium_from_numpy(jg, device="cpu", pack=pack)


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
def test_debug_channel_matches_the_jax_step(pack):
    n = 512
    jmed, med = _media(12.0, pack)
    jprm, prm = jint.IntegratorParams(**PARAMS), tint.IntegratorParams(**PARAMS)
    rng = np.random.default_rng(0)
    o = np.stack([np.full(n, -40.0), rng.uniform(-14, 14, n), rng.uniform(-14, 14, n)], -1).astype(np.float32)
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    pids = jnp.arange(n, dtype=jnp.int32)
    stream = jrng.mix_stream(3, 1)
    jstep = jint.make_step(jmed, jprm, None, collect_debug=True)
    st = jint.init_state(jmed, jnp.asarray(o), jnp.asarray(d), jprm)
    for _ in range(10):
        st, _ = jstep(st, jrng.counter_uniforms(pids, stream, st.ctr, 4))
    u = np.array(jrng.counter_uniforms(pids, stream, st.ctr, 4))
    j_next, j_dbg = jstep(st, jnp.asarray(u))

    t_st = tint.RayState(*(torch.from_numpy(np.array(x)) for x in st))
    t_next, t_dbg = tint.make_step(med, prm, None, collect_debug=True)(t_st, torch.from_numpy(u))
    assert list(t_dbg) == list(j_dbg)
    ok = np.ones(n, bool)
    for key in j_dbg:
        a, b = np.asarray(j_dbg[key]), t_dbg[key].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, key
        lane = np.isclose(a, b, rtol=1e-5, atol=1e-6) if a.dtype == np.float32 else a == b
        ok &= lane.reshape(n, -1).all(-1)
    assert ok.mean() > 0.99, ok.mean()
    assert np.asarray(j_dbg["collide"]).any() and np.asarray(j_dbg["fetch"]).any()
    # asked for nothing, the step returns the bare state, equal to the debug step's
    bare = tint.make_step(med, prm, None)(t_st, torch.from_numpy(u))
    assert isinstance(bare, tint.RayState)
    assert all(torch.equal(x, y) for x, y in zip(bare, t_next))


# ------------------------------------------------------------------ tools

RAYS = [
    (np.array([-40.0, 9.5, 0.5]), np.array([1.0, 0.02, 0.01])),  # grazes the shell
    (np.array([-40.0, 0.5, 0.2]), np.array([1.0, 0.0, 0.0])),  # through the core
    (np.array([-40.0, 30.0, 0.0]), np.array([1.0, 0.0, 0.0])),  # misses the box
]


@pytest.mark.parametrize("ray", range(len(RAYS)))
def test_majorant_segments_match_the_jax_tool(tmp_path, ray):
    jmed, med = _media()
    o, d = RAYS[ray]
    segs = ttrace.majorant_segments(med, o, d)
    ref = jtrace.majorant_segments(jmed, o, d)
    assert segs == ref
    if ray == 0:
        assert len(segs) >= 2 and len({round(s[2], 5) for s in segs}) >= 2
    if ray == 2:
        assert segs == []
    p, pj = str(tmp_path / "mt.csv"), str(tmp_path / "mtj.csv")
    ttrace.majorant_trace(med, o, d, p)
    jtrace.majorant_trace(jmed, o, d, pj)
    assert open(p).readline().strip() == "X0,Y0,Z0,X1,Y1,Z1,T0,T1,Majorant"
    assert open(p).read() == open(pj).read()


def test_dda_trace_matches_the_jax_tool(tmp_path):
    jmed, med = _media(8.0)
    o, d = np.array([-30.0, 0.5, 0.5]), np.array([1.0, 0.0, 0.0])
    p, pj = str(tmp_path / "dda.csv"), str(tmp_path / "ddaj.csv")
    rows = ttrace.dda_trace(med, o, d, p)
    ref = jtrace.dda_trace(jmed, o, d, pj)
    assert len(rows) > 10 and len(rows) == len(ref)
    for r, q in zip(rows, ref):
        assert [float(v) for v in r] == [float(v) for v in q]
        assert r[4] <= r[7] + 1e-5  # Value <= Maximum
    assert open(p).readline().strip() == "X,Y,Z,T,Value,Dim,Active,Maximum"
    assert open(p).read() == open(pj).read()


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
def test_path_events_match_the_jax_tool_and_the_render(tmp_path, pack):
    jmed, med = _media(10.0, pack)
    jprm, prm = jint.IntegratorParams(**PARAMS), tint.IntegratorParams(**PARAMS)
    o, d = np.array([-40.0, 0.5, 0.2], np.float32), np.array([1.0, 0.0, 0.0], np.float32)
    events = ttrace.trace_path_events(med, prm, None, o, d, pixel_id=5, seed=3)
    ref = jtrace.trace_path_events(jmed, jprm, None, o, d, pixel_id=5, seed=3)
    kinds = [e["kind"] for e in events]
    assert kinds == [e["kind"] for e in ref]
    assert kinds[0] == "new_ray" and kinds[-1] == "radiance" and "sampled_point" in kinds
    for e, r in zip(events, ref):
        assert sorted(e) == sorted(r)
        for key in e:
            if key not in ("kind", "terminated"):
                np.testing.assert_allclose(np.asarray(e[key], np.float64), np.asarray(r[key], np.float64),
                                           rtol=1e-5, atol=1e-6, err_msg=f"{e['kind']}.{key}")
    assert events[-1]["terminated"] == ref[-1]["terminated"]
    # the instrumented trace reproduces the production loop's result exactly
    from volume_path_tracer_tpu_torch.utils import rng as trng

    L, _, _ = tint.trace_rays(med, prm, None, torch.from_numpy(o[None]), torch.from_numpy(d[None]),
                              torch.tensor([5], dtype=torch.int32), trng.mix_stream(3, 1))
    np.testing.assert_array_equal(events[-1]["L"], L[0].numpy())
    p, pj = str(tmp_path / "log.csv"), str(tmp_path / "logj.csv")
    ttrace.write_path_events_csv(events, p)
    jtrace.write_path_events_csv(ref, pj)
    mine, theirs = open(p).read().splitlines(), open(pj).read().splitlines()
    assert mine[0].startswith("new_ray") and len(mine) == len(theirs)
    assert [ln.split(",")[0] for ln in mine] == [ln.split(",")[0] for ln in theirs]
    assert [len(ln.split(",")) for ln in mine] == [len(ln.split(",")) for ln in theirs]


def test_plot_scripts_read_the_ports_csvs(tmp_path):
    _, med = _media(8.0)
    o, d = np.array([-30.0, 0.5, 0.5]), np.array([1.0, 0.0, 0.0])
    mt, dt, lg = (str(tmp_path / n) for n in ("mt.csv", "dt.csv", "log.csv"))
    ttrace.majorant_trace(med, o, d, mt)
    ttrace.dda_trace(med, o, d, dt)
    ttrace.write_path_events_csv(ttrace.trace_path_events(med, tint.IntegratorParams(**PARAMS), None, o, d), lg)
    env = dict(os.environ, MPLBACKEND="Agg")
    for script, arg in [("scripts/plot_majorant_trace.py", mt), ("scripts/plot_dda_trace.py", dt),
                        ("scripts/plot_raytrace.py", lg)]:
        png = str(tmp_path / (os.path.basename(script) + ".png"))
        r = subprocess.run([sys.executable, script, arg, png], capture_output=True, text=True, cwd=REPO,
                           env=env, timeout=200)
        assert r.returncode == 0, (script, r.stderr[-800:])
        assert os.path.exists(png)


@pytest.mark.parametrize("source", ["procedural", "nvdb"])
def test_visualize_ray_cli(tmp_path, source, capsys):
    from volume_path_tracer_tpu_torch.tools import visualize_ray

    cfg = _write_scene(tmp_path, SCENE)
    out = tmp_path / "ray.png"
    argv = [cfg, str(out), "--cpu"] + (["--procedural", "sphere"] if source == "procedural" else ["--pixel", "11", "8"])
    assert visualize_ray.main(argv) == 0
    assert out.exists() and out.stat().st_size > 1000
    assert "majorant segments" in capsys.readouterr().out
