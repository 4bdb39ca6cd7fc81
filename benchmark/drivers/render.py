"""The render driver (mixes `progressive`, `progressive_sharded`): the
scene's grids made on the card from the seed, the medium and the scene
built, the cell's one wave shape warmed up; waves back to back for the
window; then, with the program's state freed, the reference walks a seeded
sample of the window's waves and pixels."""
from __future__ import annotations

import time

import torch

from .. import check, harness, profiling, program, scenes

KIND = "render"


def drive(cell, run: harness.Run, seed: int, seconds: float, trace: bool, t0: float):
    cfg, mix = cell.config, cell.mix
    run.kind = KIND
    dev0 = run.devices[0]
    W, H = cfg["output_size"]
    t = time.time()
    harness.startup_spans(run, t0, t)
    dens, temp = scenes.make_volume(cfg["volume"], seed, dev0)
    positions, pixels = check.sample_plan(seed, mix["check"], W * H)
    harness.reset_peak(run.devices)
    run.spans["make_inputs"] = time.time() - t
    t = time.time()
    prog = program.RenderProgram(cfg, dens, temp, seed, run.devices, program.medium_options(cfg, mix))
    del dens, temp
    run.spans["medium_build"] = prog.medium_build_s
    run.spans["program_objects"] = time.time() - t - prog.medium_build_s
    t = time.time()
    film, nc1 = prog.wave(1, None)
    film, nc2 = prog.wave(2, film)
    program.sync(run.devices)
    warm_capped = int(nc1) + int(nc2)
    del film
    run.spans["warm_up"] = time.time() - t
    run.setup_s = time.time() - t0
    run.lanes_per_unit = W * H
    with profiling.maybe_profile(trace, dev0.type == "cuda") as prof:
        span = harness.window_span() if trace else None
        keep = {p: torch.as_tensor(px, dtype=torch.int64, device=dev0) for p, px in zip(positions, pixels)}
        win, kept = program.render_window(prog, seconds, keep=keep,
                                          on_close=(lambda: span.__exit__(None, None, None)) if span else None)
    run.window = win
    run.peak_bytes = harness.peak(run.devices)
    run.trace = profiling.read(prof) if prof is not None else None
    del prog
    harness.free(run.devices)
    t_check = time.time()
    # the inputs made again from the seed: the reference reads nothing the program held
    dens, temp = scenes.make_volume(cfg["volume"], seed, dev0)
    readings, work = check.render_check(cfg, dens, temp, seed, kept, positions, pixels, dev0,
                                        win.n_capped + warm_capped, cell.limits, measure=trace)
    run.check_s = time.time() - t_check
    if work is not None:
        run.work["wave"] = work
    return readings


def control(cell, seed: int, device, dtype=torch.bfloat16) -> dict:
    """off_lanes of the reference computed in `dtype`, put in the program's
    place, on the same seeded sample of waves and pixels."""
    cfg, mix = cell.config, cell.mix
    W, H = cfg["output_size"]
    dens, temp = scenes.make_volume(cfg["volume"], seed, device)
    positions, pixels = check.sample_plan(seed, mix["check"], W * H)
    waves = [p % cfg["num_waves"] + 1 for p in positions]
    return {"control": {"off_lanes": check.render_control(cfg, dens, temp, seed, positions, pixels, waves,
                                                          device, dtype)}}
