"""Each mix end to end on the CPU at a tiny size (the test-only hook of
run.run_cell), and a normal run without a card: no result, no fallback."""
import functools
import json
import sys
import types

import pytest
import torch

from benchmark import run
from benchmark.tests import sizes


@pytest.mark.parametrize("cell", sorted(sizes.CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_tiny_on_the_cpu(cell, trace):
    res = run.run_cell(cell, sizes.SEED, 0.3, trace, device_type="cpu", sizes=sizes.CELLS[cell])
    assert run.forbidden_modules() == []
    assert res["correct"] is True, res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    c = run.Cell(cell)
    wanted = c.per_layer if trace else c.end_to_end
    assert set(res["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert "setup_s" in res["metrics"]
        assert {"render_rays_per_s", "train_rays_per_s"} & set(res["metrics"])
    else:
        assert "medium_build_s" in res["metrics"] and "breakdown" in res
    json.dumps(res)


def test_same_seed_same_inputs():
    """A seed remakes the same inputs; the cloud is its configuration's in every run."""
    from benchmark import scenes

    cloud = {"recipe": "big_cloud", "n": 16, "occupancy": 0.12, "shape_seed": 7, "voxel_size": 1.0}
    plume = {"recipe": "fire_plume", "height": 12, "radius": 4.0, "voxel_size": 1.0}
    a, b = (scenes.make_volume(cloud, s, "cpu")[0] for s in (sizes.SEED, sizes.SEED + 1))
    assert torch.equal(a.data, b.data)
    assert 0.08 < float((a.data > 0).float().mean()) < 0.16
    p, q, r = (scenes.make_volume(plume, s, "cpu")[0] for s in (sizes.SEED, sizes.SEED, sizes.SEED + 1))
    assert torch.equal(p.data, q.data) and not torch.equal(p.data, r.data)


def test_mix_medium_reaches_the_port(monkeypatch):
    """A mix's `medium` reaches Medium.from_grids as it stands, so a variant
    of the medium's path (pack=False) is a data file; training keeps the
    train step's own default, pack=False."""
    from volume_path_tracer_tpu_torch.models.medium import Medium

    seen = []
    build = Medium.from_grids
    monkeypatch.setattr(Medium, "from_grids", staticmethod(lambda *a, **k: seen.append(k) or build(*a, **k)))
    render = run._merge(sizes.RENDER, {"mix": {"medium": {"pack": False}}})
    assert run.run_cell("wdas_cloud.render", sizes.SEED, 0.2, False, device_type="cpu", sizes=render)["correct"]
    assert seen[0]["pack"] is False
    seen.clear()
    assert run.run_cell("wdas_cloud.train", sizes.SEED, 0.2, False, device_type="cpu", sizes=sizes.TRAIN)["correct"]
    assert seen[0]["pack"] is False


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "wdas_cloud.render", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc == run.NO_DEVICE
    assert capsys.readouterr().out == ""


def test_too_few_cards_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = run.main(["--workload", "wdas_cloud.render.4gpu", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc == run.NO_DEVICE
    assert capsys.readouterr().out == ""


def _loads_jax(fn):
    """fn, which then registers a module named `jax`, as a late import would."""
    def wrapped(*a, **k):
        sys.modules["jax"] = types.ModuleType("jax")
        return fn(*a, **k)
    return wrapped


@pytest.mark.parametrize("where", ["reference", "reader"])
def test_forbidden_module_stops_the_run(monkeypatch, capsys, where):
    """JAX loaded after the window (by the check's reference or by a metric
    reader) still stops the run: exit 4 and no result."""
    from benchmark import check

    monkeypatch.setitem(sys.modules, "jax", None)  # restored (removed) when the test ends
    del sys.modules["jax"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cell = "wdas_cloud.render"
    monkeypatch.setattr(run, "run_cell", functools.partial(run.run_cell, device_type="cpu", sizes=sizes.CELLS[cell]))
    if where == "reference":
        monkeypatch.setattr(check, "render_check", _loads_jax(check.render_check))
    else:
        reader = run._reader
        monkeypatch.setattr(run, "_reader", lambda path: _loads_jax(reader(path)))
    rc = run.main(["--workload", cell, "--seed", str(sizes.SEED), "--seconds", "0.3", "--trace", "0"])
    assert rc == run.FORBIDDEN_LOADED
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
