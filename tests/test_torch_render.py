"""The port's renderer, CLI and import hygiene, on the CPU.

- a 32x24, 2-wave render against the JAX package's render on the same scene
  (film weights == waves; per-channel film means within 5%, per-pixel
  agreement above 95% at rtol=1e-4, the statistic of test_torch_integrator);
- num_waves=0 gives the zero film: a deliberate difference from the JAX
  render, which raises TypeError there (int(None) on the truncation count);
- cli.main on the CPU writes a PNG that read_png reads back;
- the port imports neither jax nor the JAX package (an AST scan, and every
  module imported with jax blocked).
"""
import ast
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_path_tracer_tpu.grids import procedural as jproc
from volume_path_tracer_tpu.models.medium import Medium as JMedium
from volume_path_tracer_tpu.render.renderer import Scene as JScene
from volume_path_tracer_tpu.render.renderer import render as j_render
from volume_path_tracer_tpu.utils.config import loads_configuration as j_loads
from volume_path_tracer_tpu_torch.grids import procedural as tproc
from volume_path_tracer_tpu_torch.io.png import read_png
from volume_path_tracer_tpu_torch.models.medium import Medium
from volume_path_tracer_tpu_torch.render import megakernel as tmk
from volume_path_tracer_tpu_torch.render.renderer import Scene, render, render_wave_image
from volume_path_tracer_tpu_torch.utils.config import loads_configuration

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "volume_path_tracer_tpu_torch")

SCENE = {
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
    "seed": 10, "output_size": [32, 24], "tile_size": [8, 8], "num_waves": 2,
    "num_workers": 1, "volume_path": "vol.nvdb",
    "camera_parameters": {"position": [42.0, 0.0, 0.0], "look": [0.0, 0.0, 0.0],
                          "up": [0.0, 1.0, 0.0], "vfov_deg": 40.0, "imaging_ratio": 0.1},
}


def _scene(scene=SCENE, max_iters=1024):
    cfg = loads_configuration(json.dumps(scene))
    med = Medium.from_grids(tproc.fog_sphere(10.0, 3.0), device="cpu")
    return Scene.from_config(cfg, med, max_iters=max_iters, device="cpu")


def test_render_matches_jax():
    sc = _scene()
    film = render(sc, device="cpu").numpy()
    assert film.shape == (24, 32, 4)
    assert (film[..., 3] == 2.0).all()
    assert np.isfinite(film).all()

    jcfg = j_loads(json.dumps(SCENE))
    jsc = JScene.from_config(jcfg, JMedium.from_grids(jproc.fog_sphere(10.0, 3.0)), max_iters=1024)
    jfilm = np.asarray(j_render(jsc))
    assert (jfilm[..., 3] == film[..., 3]).all()
    px = np.isclose(film[..., :3], jfilm[..., :3], rtol=1e-4, atol=1e-5).all(-1).mean()
    assert px > 0.95, px
    m, jm = film[..., :3].mean((0, 1)), jfilm[..., :3].mean((0, 1))
    assert (np.abs(m - jm) / np.abs(jm) < 0.05).all(), (m, jm)


def test_render_zero_waves_gives_zero_film():
    sc = _scene()
    film = render(sc, num_waves=0, device="cpu")
    assert film.shape == (24, 32, 4) and not film.any()
    jcfg = j_loads(json.dumps(SCENE))
    jsc = JScene.from_config(jcfg, JMedium.from_grids(jproc.fog_sphere(10.0, 3.0)), max_iters=64)
    with pytest.raises(TypeError):  # the JAX render's int(None): not copied
        j_render(jsc, num_waves=0)


def test_chunked_wave_equals_whole_wave():
    sc = _scene()
    whole = render_wave_image(sc, 1)
    seen = []
    chunked = render_wave_image(sc, 1, chunk_pixels=100,
                                chunk_callback=lambda done, total, f: seen.append(done))
    assert torch.equal(whole, chunked)
    assert seen == list(range(100, 768, 100))


def test_single_pixel_mode():
    scene = json.loads(json.dumps(SCENE))
    scene["worker_parameters"]["single_pixel"] = {"enabled": True, "coord": [16, 12]}
    sc = _scene(scene)
    film, ncap = render_wave_image(sc, 1, return_ncap=True)
    assert int(ncap) == 0
    hit = film[..., 3].nonzero().tolist()
    assert hit == [[12, 16]]


def test_wave_callback_stops_render():
    sc = _scene()
    waves = []
    film = render(sc, num_waves=5, wave_callback=lambda w, f: waves.append(w) or w < 2, device="cpu")
    assert waves == [1, 2] and (film[..., 3] == 2.0).all()


def test_cpu_scene_goes_through_plain_path():
    sc = _scene()
    launches = tmk.LAUNCHES
    render(sc, num_waves=1, device="cpu")
    assert tmk.LAUNCHES == launches  # no CUDA kernel on a CPU medium


def test_render_device_must_be_explicit_without_cuda():
    sc = _scene()
    with pytest.raises((RuntimeError, ValueError)):
        render(sc)  # default device is CUDA: absent here, or not the scene's


def _write_scene(tmp_path, scene=SCENE):
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(scene))
    return str(p)


def test_cli_renders_on_cpu(tmp_path):
    from volume_path_tracer_tpu_torch import cli

    out = tmp_path / "out.png"
    ck = tmp_path / "ck.npz"
    rc = cli.main([_write_scene(tmp_path), str(out), "--cpu", "--procedural", "sphere",
                   "--waves", "1", "--checkpoint", str(ck)])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape == (24, 32, 3) and img.dtype == np.uint8
    assert img.max() > 0
    assert ck.exists()
    # resume: the checkpoint holds wave 1, so wave 2 is the only one rendered
    rc = cli.main([_write_scene(tmp_path), str(out), "--cpu", "--procedural", "sphere",
                   "--waves", "2", "--checkpoint", str(ck)])
    assert rc == 0
    z = np.load(str(ck))
    assert int(z["wave"]) == 2 and (z["film"][..., 3] == 2.0).all()


def test_cli_nvdb_not_ported(tmp_path, capsys):
    from volume_path_tracer_tpu_torch import cli

    # The scene's .nvdb is read since the file I/O was ported; what stays
    # fatal is a volume file that is absent, with the hint at --procedural
    # (tests/test_torch_cli_tools.py renders from a written file).
    with pytest.raises(SystemExit) as e:
        cli.main([_write_scene(tmp_path), str(tmp_path / "o.png"), "--cpu"])
    assert e.value.code == 1
    err = capsys.readouterr().err
    assert "vol.nvdb" in err and "not found" in err and "--procedural" in err


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(mods)


def test_port_imports_nothing_of_jax_ast_scan():
    bad = []
    for mod in _port_modules():
        path = os.path.join(REPO, *mod.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(REPO, *mod.split("."), "__init__.py")
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "volume_path_tracer_tpu"):
                    bad.append(f"{mod}: {n}")
    assert len(_port_modules()) >= 15
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'volume_path_tracer_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not [m for m in sys.modules if m.startswith('jax') and sys.modules[m] is not None]\n"
        "print(len(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip()) == len(_port_modules())
