"""The port's examples on the CPU, in this process, at small sizes.

examples/inverse_rendering.py (density from three views, and --joint
density and temperature) for 3 steps at 24x24: the loss falls, the images
and (--joint) the curve's JSON are written under --out and nowhere else;
examples/multihost_render.py --cpu in one process at 16x16: the film's
weights, the reported rays and lane-iterations, and the port's mesh.
"""
import json

import numpy as np
import torch

from volume_path_tracer_tpu_torch.examples import inverse_rendering, multihost_render

torch.set_num_threads(2)


def test_inverse_rendering_density_loss_falls(tmp_path):
    out = tmp_path / "density"
    s = inverse_rendering.main(["--cpu", "--steps", "3", "--out", str(out)])
    assert s["mode"] == "density" and s["image"] == [24, 24] and s["train_steps"] == 9
    assert np.isfinite(s["loss_first"]) and s["loss_last"] < s["loss_first"]
    assert np.isfinite(s["vox_corr"])
    assert sorted(p.name for p in out.iterdir()) == sorted(
        [f"target_v{i}.png" for i in range(3)] + [f"recovered_v{i}.png" for i in range(3)])


def test_inverse_rendering_joint_loss_and_error_fall(tmp_path):
    out = tmp_path / "joint"
    s = inverse_rendering.main(["--cpu", "--joint", "--steps", "3", "--out", str(out)])
    assert s["loss_last"] < s["loss_first"] and s["temp_mae_final"] < s["temp_mae_init"]
    assert sorted(p.name for p in out.iterdir()) == ["joint_recovered.png", "joint_recovery.json",
                                                     "joint_target.png"]
    rec = json.loads((out / "joint_recovery.json").read_text())
    assert [c["step"] for c in rec["curve"]] == [1, 2, 3] and rec["steps"] == 3


def test_multihost_render_one_process(tmp_path, capsys):
    dump = tmp_path / "film.npz"
    s = multihost_render.main(["--cpu", "--size", "16", "--waves", "2", "--local-cells", "2",
                               "--dump", str(dump)])
    assert s["processes"] == 1 and s["mesh"] == {"rays": 2, "spp": 1} and s["rays"] == 16 * 16 * 2
    assert s["film_mean_w"] == 2.0 and s["lane_iterations_per_wave"] > 0 and s["rays_per_s"] > 0
    film = np.load(dump)["film"]
    assert film.shape == (16, 16, 4) and np.isfinite(film).all() and film[..., :3].max() > 0
    assert "lane-iterations/wave (topology-invariant)" in capsys.readouterr().out
