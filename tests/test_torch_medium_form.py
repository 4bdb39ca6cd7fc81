"""The medium's form on the device, chosen in one place (models/medium.py
choose_pack), and the command line's use of it, on the CPU.

- choose_pack packs below the fused table's row and memory limits and
  chooses the dense arrays past either, from the grids' shapes and
  transforms alone (meta tensors, the device's free memory given through
  free_bytes_on): the table is (X+1)(Y+1)(Z+1) corner rows plus a majorant
  row a brick, 8 floats a row, 16 with an alignment-compatible temperature
  fused, and else 8-wide temperature corner rows beside it; the packed
  build's peak adds the packer's zero-padded copy of the grid and, with a
  fused temperature, its [X+2, Y+2, Z+2] array (the card test
  tests/test_torch_cuda_dense_large.py holds this to the allocator's peak);
- Medium.form and Medium.resident_bytes say which form a medium took and
  what it holds on its device;
- cli.main packs where the table fits and reads the dense arrays where it
  does not, writes the same PNG byte for byte either way (the dense and
  packed plain paths sum alike; see tests/test_torch_unpacked.py), and
  prints the form and the resident bytes at set-up.
"""
import json

import pytest
import torch

from volume_path_tracer_tpu_torch import cli
from volume_path_tracer_tpu_torch.grids import procedural as tproc
from volume_path_tracer_tpu_torch.grids.grid import dense_grid_from_array
from volume_path_tracer_tpu_torch.io.png import read_png
from volume_path_tracer_tpu_torch.models import medium as tmed
from volume_path_tracer_tpu_torch.models.medium import Medium, choose_pack, packed_bytes

GB = 10 ** 9


def _meta(shape, origin=(0, 0, 0), voxel=1.0, offset=(0.0, 0.0, 0.0)):
    return dense_grid_from_array(torch.empty(shape, dtype=torch.float32, device="meta"), origin, voxel, offset)


def _free(monkeypatch, n):
    """The device's free memory, as choose_pack reads it, set to n bytes."""
    monkeypatch.setattr(tmed, "free_bytes_on", lambda dev: n)


def _held_and_peak(shape, width=8, temperature=None, trows=False):
    """What a packed medium holds on the device and its build's peak, counted
    here from the rule."""
    X, Y, Z = shape
    b = [-(-n // 8) for n in shape]
    nb = b[0] * b[1] * b[2]
    ns = 1
    for v in b:
        ns *= -(-v // 8)
    held = ((X + 1) * (Y + 1) * (Z + 1) + nb) * width * 4 + X * Y * Z * 4 + (3 * nb + ns) * 4
    padded = (X + 2) * (Y + 2) * (Z + 2) * 4
    copies = padded * (2 if width == 16 else 1)
    if temperature is not None:
        TX, TY, TZ = temperature
        held += TX * TY * TZ * 4
        if trows:
            held += (TX + 1) * (TY + 1) * (TZ + 1) * 32
            copies = max(copies, (TX + 2) * (TY + 2) * (TZ + 2) * 4)
    return held, held + copies


def test_packs_below_both_limits_and_reads_dense_past_the_memory(monkeypatch):
    d = _meta((512, 512, 512))
    held, peak = _held_and_peak((512, 512, 512))
    assert 4.8 * GB < held < 4.9 * GB  # the cloud's 4.33 GB table, its 0.54 GB grid, majorants
    assert peak - held == 514 ** 3 * 4  # the packer's padded copy of the grid
    assert packed_bytes(d) == (513 ** 3 + 64 ** 3, held, peak)
    for free, pack in ((80 * GB, True), (peak, True), (peak - 1, False)):
        _free(monkeypatch, free)
        assert choose_pack(d, device="cpu") is pack
    # one wave's working set over the frame's pixels must fit beside the medium
    px = 1920 * 1080
    wave = px * tmed.WAVE_BYTES_PER_PIXEL
    assert wave < peak - held
    _free(monkeypatch, peak)
    assert choose_pack(d, device="cpu", pixels=px)
    big = 10 ** 8  # more pixels than the padded copy's bytes hold waves of
    _free(monkeypatch, held + big * tmed.WAVE_BYTES_PER_PIXEL)
    assert choose_pack(d, device="cpu", pixels=big)
    _free(monkeypatch, held + big * tmed.WAVE_BYTES_PER_PIXEL - 1)
    assert not choose_pack(d, device="cpu", pixels=big)


def test_reads_dense_past_the_row_limit_whatever_the_memory(monkeypatch):
    # 1289^3: 1290^3 corner rows and 162^3 majorant rows, 2,150,940,528,
    # past 2^31; 1288^3: 1289^3 + 161^3 = 2,145,873,850 rows, below
    _free(monkeypatch, 10 ** 15)
    assert not choose_pack(_meta((1289, 1289, 1289)), device="cpu")
    assert choose_pack(_meta((1288, 1288, 1288)), device="cpu")
    assert not choose_pack(_meta((1300, 1300, 1300)), device="cpu")
    # 1288^3 at the card's 84.47 GB free: 68.67 GB of table and 8.55 GB of
    # grid fit, with the packer's 8.59 GB padded copy beside them they do not
    _, held, peak = packed_bytes(_meta((1288, 1288, 1288)))
    assert held < 84.47 * GB < peak
    _free(monkeypatch, int(84.47 * GB))
    assert not choose_pack(_meta((1288, 1288, 1288)), device="cpu")


def test_a_fused_temperature_doubles_the_row_and_a_misaligned_one_adds_its_own_rows(monkeypatch):
    shape = (64, 80, 48)
    d = _meta(shape, origin=(-32, 0, -24))
    aligned = _meta((40, 60, 30), origin=(-20, 0, -15))
    own = _meta((40, 60, 30), origin=(-20, 0, -15), offset=(0.3, 0.0, 0.0))
    for t, kw in ((aligned, {"width": 16}), (own, {"trows": True})):
        held, peak = _held_and_peak(shape, temperature=(40, 60, 30), **kw)
        assert packed_bytes(d, t)[1:] == (held, peak)
        _free(monkeypatch, peak)
        assert choose_pack(d, t, device="cpu")
        _free(monkeypatch, peak - 1)
        assert not choose_pack(d, t, device="cpu")
    # a fused temperature's [X+2, Y+2, Z+2] array lives beside the padded copy
    held, peak = _held_and_peak(shape, width=16, temperature=(40, 60, 30))
    assert peak - held == 2 * 66 * 82 * 50 * 4
    # a temperature table of 2^31 rows or more is refused as the density's is
    _free(monkeypatch, 10 ** 15)
    assert not choose_pack(d, _meta((1300, 1300, 1300), offset=(0.3, 0.0, 0.0)), device="cpu")


def test_without_a_figure_it_asks_the_device(monkeypatch):
    d = _meta((32, 32, 32))
    assert choose_pack(d, device="cpu") in (True, False)
    _free(monkeypatch, None)
    assert choose_pack(d, device="cpu")  # unknown memory: only the row limit
    _free(monkeypatch, 1000)
    assert not choose_pack(d, device="cpu")


def test_form_and_resident_bytes():
    d, t = tproc.fire_plume(height=16, radius=5.0)
    packed = Medium.from_grids(d, t, device="cpu")
    dense = Medium.from_grids(d, t, pack=False, device="cpu")
    assert (packed.form, dense.form) == ("packed", "dense")
    m = dense.majorants
    grids = d.data.nbytes + t.data.nbytes + m.brick_maj.nbytes + m.super_maj.nbytes + m.rows.nbytes
    assert dense.resident_bytes == grids
    extra = packed.density_rows.nbytes + (packed.temperature_rows.nbytes if packed.temperature_rows is not None else 0)
    assert packed.resident_bytes == grids + extra
    assert packed.density_rows.nbytes >= 8 * d.data.nbytes
    # packed_bytes counts what the packed medium holds
    assert packed_bytes(d, t)[1] == packed.resident_bytes


SCENE = {
    "output_size": [24, 16],
    "worker_parameters": {
        "single_pixel": {"enabled": False, "coord": [0, 0]},
        "infinite_light": {"xyz": [0.25, 0.25, 0.5], "multiplier": 2},
        "distant_light": {"xyz": [0.95, 1.0, 1.09], "multiplier": 5, "inv_direction": [0.5, 1, 0]},
        "use_jitter": True, "max_depth": 40,
    },
    "volume_parameters": {
        "sigma_s": 0.2, "sigma_a": 0.05, "henyey_greenstein_g": 0.3,
        "le_scale": 0.0, "temperature_offset": 300.0, "temperature_scale": 40.0,
    },
    "seed": 7, "tile_size": [8, 8], "num_waves": 2, "num_workers": 1,
    "volume_path": "absent.nvdb",
    "camera_parameters": {"position": [90, 0, 0], "look": [0, 0, 0], "up": [0, 1, 0],
                          "vfov_deg": 35, "imaging_ratio": 0.1},
}


def _cli(tmp_path, capsys, *extra):
    cfg = tmp_path / "scene.json"
    cfg.write_text(json.dumps(SCENE))
    out = tmp_path / f"out{len(list(tmp_path.glob('out*.png')))}.png"
    assert cli.main([str(cfg), str(out), "--cpu", "--procedural", "sphere", "--waves", "1", *extra]) == 0
    return read_png(str(out)), capsys.readouterr().err


def test_cli_dense_writes_the_packed_png_and_says_its_form(tmp_path, capsys, monkeypatch):
    packed, err_p = _cli(tmp_path, capsys, "--profile", str(tmp_path / "prof_p"))
    _free(monkeypatch, 4 * 10 ** 6)  # under the sphere's 8-wide table
    dense, err_d = _cli(tmp_path, capsys, "--profile", str(tmp_path / "prof_d"))
    assert packed.max() > 0
    assert (packed == dense).all()
    sphere = Medium.from_grids(tproc.fog_sphere(radius=24.0, falloff=4.0), pack=False, device="cpu")
    assert f"medium: dense, {sphere.resident_bytes / 1e9:.3f} GB resident on cpu" in err_d
    assert "medium: packed," in err_p
    assert (tmp_path / "prof_d" / "trace.json").exists()


def test_cli_auto_packs_where_the_table_fits_and_reads_dense_where_not(tmp_path, capsys, monkeypatch):
    auto, err = _cli(tmp_path, capsys)
    assert "medium: packed," in err
    _free(monkeypatch, 4 * 10 ** 6)
    small, err = _cli(tmp_path, capsys)
    assert "medium: dense," in err
    assert (auto == small).all()
    # the form is the device's to choose: the command line has no flag for it
    with pytest.raises(SystemExit):
        cli.main([str(tmp_path / "scene.json"), str(tmp_path / "x.png"), "--cpu", "--medium", "dense"])
