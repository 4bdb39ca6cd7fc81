"""The training driver (mix `multiview_fit`): the cloud and the targets
made on the card from the seed, the train step of every view built, the
first steps (one through each view) taken through the window's own call
and their loss, first gradient and parameters' change read; steps for the
window; then, with the program's state freed, the reference takes the
first steps itself."""
from __future__ import annotations

import contextlib
import time

import torch

from .. import check, harness, profiling, program, scenes

KIND = "train"


def inputs(cfg: dict, mix: dict, seed: int, device):
    """(the cloud, its log density p0 = softplus^-1 of the density, the targets)."""
    dens, _ = scenes.make_volume(cfg["volume"], seed, device, n_override=mix["volume_n"])
    d = torch.clamp(dens.data, min=1e-4)
    t = mix["target"]
    w, h = mix["pixels"]
    return (dens, d + torch.log(-torch.expm1(-d)),
            scenes.smooth_targets(mix["views"], w, h, seed, device, t["background"], t["peak"]))


def drive(cell, run: harness.Run, seed: int, seconds: float, trace: bool, t0: float):
    cfg, mix = cell.config, cell.mix
    run.kind = KIND
    dev0 = run.devices[0]
    t_in = time.time()
    harness.startup_spans(run, t0, t_in)
    dens, p0, targets = inputs(cfg, mix, seed, dev0)
    harness.reset_peak(run.devices)
    run.spans["make_inputs"] = time.time() - t_in
    t = time.time()
    prog = program.TrainProgram(cfg, mix, dens, p0, targets, seed, run.devices)
    del dens
    run.spans["medium_build"] = prog.medium_build_s
    run.spans["program_objects"] = time.time() - t - prog.medium_build_s
    t_warm = time.time()
    n_check = mix["check"]["steps"]
    losses, gnorm, upd = [], None, None
    for i in range(mix["views"]):
        loss = prog.step(i)
        if i < n_check:
            losses.append(float(loss))
        if i == 0:
            gnorm = float(prog.first_gradient().double().norm())
        if i == n_check - 1:
            upd = float((prog.param.detach() - p0).double().norm())
    prog.save()
    program.sync(run.devices)
    run.spans["warm_up"] = time.time() - t_warm
    del p0
    run.setup_s = time.time() - t0
    run.lanes_per_unit = prog.lanes
    with profiling.maybe_profile(trace, dev0.type == "cuda") as prof:
        with torch.profiler.record_function(profiling.WINDOW) if trace else contextlib.nullcontext():
            win = program.train_window(prog, seconds, first=mix["views"], restore_every=mix["restore_every"])
    run.window = win
    run.peak_bytes = harness.peak(run.devices)
    run.trace = profiling.read(prof) if prof is not None else None
    del prog
    harness.free(run.devices)
    t_check = time.time()
    dens, p0, targets = inputs(cfg, mix, seed, dev0)  # made again: nothing the program held
    r_losses, r_gnorm, r_upd, work = check.reference_steps(cfg, mix, dens, p0, targets, seed, n_check, dev0,
                                                           measure=trace)
    run.check_s = time.time() - t_check
    if work is not None:
        run.work["record"] = run.work["replay"] = work
    nums = check.train_numbers(losses, gnorm, upd, r_losses, r_gnorm, r_upd)
    return {k: check.Reading(v, cell.limits[k]) for k, v in nums.items()}


def control(cell, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The control's numbers, and each fault's, read by planting it in the
    reference: {"control": {...}, "half": {...}, ...}."""
    cfg, mix = cell.config, cell.mix
    w, h = mix["pixels"]
    dens, p0, targets = inputs(cfg, mix, seed, device)
    n = mix["check"]["steps"]
    ref = check.reference_steps(cfg, mix, dens, p0, targets, seed, n, device)
    low = check.reference_steps(cfg, mix, dens, p0, targets, seed, n, device, dtype=dtype)
    half = check.reference_steps(cfg, mix, dens, p0, targets, seed, n, device, rows=w * h // 2)
    return {
        "control": check.train_numbers(low[0], low[1], low[2], ref[0], ref[1], ref[2]),
        "half": check.train_numbers(half[0], half[1], half[2], ref[0], ref[1], ref[2]),
        # the answer altered where it is produced: the loss (and so its gradient) scaled by 1.01
        "altered": check.train_numbers([x * 1.01 for x in ref[0]], ref[1] * 1.01, ref[2], ref[0], ref[1], ref[2]),
        # a step that returns its state unchanged: no parameter moves
        "unchanged": check.train_numbers(ref[0], ref[1], 0.0, ref[0], ref[1], ref[2]),
    }
