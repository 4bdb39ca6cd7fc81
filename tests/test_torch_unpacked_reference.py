"""The port's plain unpacked render against the benchmark's plain reference,
on the CPU.

The cell wdas_cloud.render.unpacked at the render cells' tiny size
(benchmark/tests/sizes.py RENDER: a seeded 24^3 big_cloud, 24 x 14 pixels):
the port's wave through the benchmark's own RenderProgram, whose medium the
mix builds with pack=False (no fused table; on the CPU render_wave_plain's
generic arm reads the grid's own array), against benchmark/reference/walk.py
walking the same pixels of the same wave on the same draws from the raw
grid. The reference is plain torch and imports neither JAX nor the port.
Statistic of the repository's parity tests: more than 95% of lanes close
(rtol 1e-4, atol 1e-5), channel means within 5%; every weight is 1 and no
lane is capped.
"""
import numpy as np
import pytest
import torch

from benchmark import check, program, run, scenes
from benchmark.tests import sizes
from volume_path_tracer_tpu_torch.render import megakernel

CELL = "wdas_cloud.render.unpacked"


@pytest.mark.parametrize("seed,wave", [(sizes.SEED, 1), (3_200_000_017, 5)])
def test_plain_unpacked_wave_matches_the_reference(seed, wave):
    cell = run.Cell(CELL, sizes=sizes.RENDER)
    cfg = cell.config
    W, H = cfg["output_size"]
    dens, _ = scenes.make_volume(cfg["volume"], seed, "cpu")
    assert tuple(dens.data.shape) == (24, 24, 24)
    prog = program.RenderProgram(cfg, dens, None, seed, [torch.device("cpu")], program.medium_options(cfg, cell.mix))
    assert prog.medium.form == "dense" and prog.medium.density_rows is None
    plain = megakernel.PLAIN_WAVE_LAUNCHES
    film, n_capped = prog.wave(wave, None)
    assert megakernel.PLAIN_WAVE_LAUNCHES == plain + 1
    got = film.reshape(-1, 4)
    want, ref_capped, _ = check.reference_waves(cfg, dens, None, seed, [wave], [np.arange(W * H)], "cpu")
    assert int(n_capped) == 0 and ref_capped == 0
    assert torch.equal(got[:, 3], torch.ones(W * H))
    L, ref = got[:, :3].numpy(), want.numpy()
    assert ref.mean() > 0
    close = np.isclose(L, ref, rtol=1e-4, atol=1e-5).all(-1).mean()
    assert close > 0.95, close
    rel = np.abs(L.mean(0) - ref.mean(0)) / (np.abs(ref.mean(0)) + 1e-9)
    assert (rel < 0.05).all(), rel
