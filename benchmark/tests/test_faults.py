"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped (the CPU hook) and the rest of a run
is driven, once for each fault a cell can have."""
import pytest
import torch

from benchmark import run
from benchmark.tests import sizes
from volume_path_tracer_tpu_torch.diff import inverse
from volume_path_tracer_tpu_torch.parallel import shard
from volume_path_tracer_tpu_torch.render import renderer


def _run(cell):
    return run.run_cell(cell, sizes.SEED, 0.3, False, device_type="cpu", sizes=sizes.CELLS[cell])


def _wave_fault(kind):
    orig = renderer.render_wave_image

    def broken(scene, wave, film=None, chunk_pixels=None, chunk_callback=None, return_ncap=False):
        before = torch.zeros((scene.height, scene.width, 4)) if film is None else film
        out, ncap = orig(scene, wave, film, chunk_pixels, chunk_callback, return_ncap=True)
        flat, prev = out.view(-1, 4), before.reshape(-1, 4)
        if kind == "unchanged":
            out = before.clone()
        elif kind == "half":
            flat[flat.shape[0] // 2:] = prev[flat.shape[0] // 2:]
        elif kind == "altered":
            flat[:, :3] = prev[:, :3] + (flat[:, :3] - prev[:, :3]) * 1.01
        return out, ncap
    return broken


@pytest.mark.parametrize("cell", ["wdas_cloud.render", "fire.render"])
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("cell", ["wdas_cloud.render", "fire.render"])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_wave_is_not_correct(monkeypatch, cell, kind):
    monkeypatch.setattr(renderer, "render_wave_image", _wave_fault(kind))
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "exchange"])
def test_broken_sharded_wave_is_not_correct(monkeypatch, kind):
    orig = shard.render_wave_sharded

    def broken(mesh, *a, **k):
        contrib, *rest = orig(mesh, *a, **k)
        n = contrib.shape[0]
        if kind == "unchanged":
            contrib = torch.zeros_like(contrib)
        elif kind == "half":
            contrib[n // 2:] = 0
        elif kind == "altered":
            contrib[:, :3] *= 1.01
        elif kind == "exchange":  # only the first card's rows reach the sum
            contrib[n // mesh.shape["rays"]:] = 0
        return (contrib, *rest)

    monkeypatch.setattr(shard, "render_wave_sharded", broken)
    assert _run("wdas_cloud.render.4gpu")["correct"] is False


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_train_step_is_not_correct(monkeypatch, kind):
    make_step, make_loss = inverse.make_train_step, inverse.make_render_loss

    def broken_step(*a, **k):
        step = make_step(*a, **k)

        def run_step(grids, opt, raster, pids, target_px, seed_wave):
            if kind == "unchanged":
                keep = [p.detach().clone() for p in inverse.grid_leaves(grids)]
                out = step(grids, opt, raster, pids, target_px, seed_wave)
                with torch.no_grad():
                    for p, q in zip(inverse.grid_leaves(grids), keep):
                        p.copy_(q)
                return out
            if kind == "half":
                n = pids.shape[0] // 2
                return step(grids, opt, raster[:n], pids[:n], target_px[:n], seed_wave)
            return step(grids, opt, raster, pids, target_px, seed_wave)
        return run_step

    def altered_loss(*a, **k):
        loss = make_loss(*a, **k)

        def fn(*b, **c):
            sq, n = loss(*b, **c)
            return sq * 1.01, n
        return fn

    monkeypatch.setattr(inverse, "make_train_step", broken_step)
    if kind == "altered":
        monkeypatch.setattr(inverse, "make_render_loss", altered_loss)
    assert _run("wdas_cloud.train")["correct"] is False
