"""The joint-fit driver (mix `joint_fit`): the density and the temperature of
an emissive medium recovered together. The grids and the targets are made on
the card from the seed, the joint train step of every view built
(inverse.make_train_step with dual_buffer=True over OptimizableGrids(log
density, temperature), one Adam over both), the first steps (one through
each view) taken through the window's own call, their loss, both leaves'
first gradients and both leaves' change read; steps for the window; then,
with the program's state freed, the reference (reference/emission.py) takes
the first steps itself."""
from __future__ import annotations

import contextlib
import time

import torch

from volume_path_tracer_tpu_torch.diff import inverse
from volume_path_tracer_tpu_torch.utils.spectral import blackbody_xyz_table, breakpoints_for_max_temp

from .. import check, harness, profiling, program, roofline_emission, scenes
from ..reference import emission as ref

KIND = "train"


def inputs(cfg: dict, mix: dict, seed: int, device):
    """(density Grid, temperature Grid, log density p0 = softplus^-1 of the
    density, the targets): the fit starts from the stand-in itself."""
    dens, temp = scenes.make_volume(cfg["volume"], seed, device)
    d = torch.clamp(dens.data, min=1e-4)
    t = mix["target"]
    w, h = mix["pixels"]
    return (dens, temp, d + torch.log(-torch.expm1(-d)),
            scenes.smooth_targets(mix["views"], w, h, seed, device, t["background"], t["peak"]))


def fit(cfg: dict, mix: dict) -> ref.Fit:
    """The job as the reference takes it, from the configuration and the mix."""
    job = cfg["fit"]
    if job["optimise"] != list(ref.LEAVES) or job["estimator"] != "dual_buffer":
        raise ValueError(f"the joint fit optimises {ref.LEAVES} by the dual buffer, not {job}")
    return ref.Fit(transport=scenes.transport(cfg),
                   cameras=scenes.ring_cameras(mix["views"], mix["ring_radius"], mix["ring_height"]),
                   look=mix["look"], up=cfg["camera"]["up"], vfov_deg=mix["vfov_deg"], pixels=mix["pixels"],
                   imaging_ratio=cfg["camera"]["imaging_ratio"], jitter=cfg["use_jitter"],
                   samples=mix["samples_per_step"], n_iters=job["n_iters"], lr=mix["lr"],
                   bloat=job["majorant_bloat"])


class JointProgram:
    """Inverse rendering of a density and a temperature grid from a ring of
    views: the port's joint train step, one view a step."""

    def __init__(self, cfg: dict, mix: dict, density, temperature, p0: torch.Tensor, targets: torch.Tensor,
                 seed: int, devices):
        dev = devices[0]
        self.devices = devices
        self.base, self.medium_build_s = program.build_medium(devices, density, temperature,
                                                              **program.medium_options(cfg, mix, pack=False))
        job = fit(cfg, mix)
        if job.bloat != 0.1:
            raise ValueError(f"the train step builds its majorants with bloat 0.1, not {job.bloat}")
        w, h = mix["pixels"]
        params = program._params(cfg, job.n_iters)
        t_max = float(temperature.data.max()) * params.temperature_scale + params.temperature_offset
        bb = torch.from_numpy(blackbody_xyz_table(breakpoints_for_max_temp(t_max))).to(dev)
        self.steps = [
            inverse.make_train_step(self.base, params,
                                    program._camera(pos, job.look, job.up, job.vfov_deg, job.imaging_ratio, w, h,
                                                    dev),
                                    bb, n_iters=job.n_iters, samples_per_step=job.samples, dual_buffer=True)
            for pos in job.cameras
        ]
        self.grids = inverse.OptimizableGrids(p0.clone().requires_grad_(True),
                                              temperature.data.clone().requires_grad_(True))
        self.opt = inverse.make_optimizer(self.grids, lr=job.lr)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.int32), torch.arange(w, dtype=torch.int32), indexing="ij")
        self.raster = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(dev)
        self.pids = torch.arange(w * h, dtype=torch.int32, device=dev)
        self.targets = targets
        self.seed32 = int(seed) & 0xFFFFFFFF
        self.lanes = w * h * job.samples
        self.saved = None

    @property
    def leaves(self):
        return dict(zip(ref.LEAVES, inverse.grid_leaves(self.grids)))

    def step(self, i: int) -> torch.Tensor:
        """Step i: view i mod views, waves of seed-wave (seed, i); its loss (not read)."""
        v = i % len(self.steps)
        _, _, loss = self.steps[v](self.grids, self.opt, self.raster, self.pids, self.targets[v], (self.seed32, i))
        return loss

    def first_gradients(self) -> dict:
        """Each leaf's gradient at the optimizer's first step, from its state (m1 / (1 - beta1))."""
        b1 = self.opt.param_groups[0]["betas"][0]
        return {q: self.opt.state[p]["exp_avg"] / (1.0 - b1) for q, p in self.leaves.items()}

    def save(self):
        self.saved = [(p.detach().clone(), {k: v.clone() for k, v in self.opt.state[p].items()})
                      for p in self.leaves.values()]

    def restore(self):
        for p, (keep, st) in zip(self.leaves.values(), self.saved):
            with torch.no_grad():
                p.copy_(keep)
            for k, v in self.opt.state[p].items():
                v.copy_(st[k])


def drive(cell, run: harness.Run, seed: int, seconds: float, trace: bool, t0: float):
    cfg, mix = cell.config, cell.mix
    run.kind = KIND
    dev0 = run.devices[0]
    t_in = time.time()
    harness.startup_spans(run, t0, t_in)
    dens, temp, p0, targets = inputs(cfg, mix, seed, dev0)
    harness.reset_peak(run.devices)
    run.spans["make_inputs"] = time.time() - t_in
    t = time.time()
    prog = JointProgram(cfg, mix, dens, temp, p0, targets, seed, run.devices)
    start = {"density": p0, "temperature": temp.data}  # the program optimises copies
    del dens, temp
    run.spans["medium_build"] = prog.medium_build_s
    run.spans["program_objects"] = time.time() - t - prog.medium_build_s
    t_warm = time.time()
    n_check = mix["check"]["steps"]
    losses, gnorms, upd = [], None, None
    for i in range(mix["views"]):
        loss = prog.step(i)
        if i < n_check:
            losses.append(float(loss))
        if i == 0:
            gnorms = {q: float(g.double().norm()) for q, g in prog.first_gradients().items()}
        if i == n_check - 1:
            upd = {q: float((p.detach() - start[q]).double().norm()) for q, p in prog.leaves.items()}
    prog.save()
    program.sync(run.devices)
    run.spans["warm_up"] = time.time() - t_warm
    del p0, start
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
    dens, temp, p0, targets = inputs(cfg, mix, seed, dev0)  # made again: nothing the program held
    r = ref.reference_steps(fit(cfg, mix), dens, temp, p0, temp.data, targets, seed, n_check, dev0, measure=trace)
    run.check_s = time.time() - t_check
    if r.counts is not None:
        c = r.counts
        run.work["record"] = run.work["replay"] = roofline_emission.Work(
            lanes=c["lanes"], lane_steps=c["lane_steps"], corners=c["corners"], pairs=c["bricks"],
            tcorners=c["tcorners"], emissive=c["emissive"])
    nums = ref.joint_numbers(ref.Steps(losses, gnorms, upd, None), r)
    return {k: check.Reading(v, cell.limits[k]) for k, v in nums.items()}


def control(cell, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The control's numbers, and each fault's, read by planting it in the
    reference: {"control": {...}, "half": {...}, ...}."""
    cfg, mix = cell.config, cell.mix
    w, h = mix["pixels"]
    dens, temp, p0, targets = inputs(cfg, mix, seed, device)
    job = fit(cfg, mix)
    n = mix["check"]["steps"]

    def steps(**kw):
        return ref.reference_steps(job, dens, temp, p0, temp.data, targets, seed, n, device, **kw)

    good = steps()
    out = {"control": ref.joint_numbers(steps(dtype=dtype), good),
           "half": ref.joint_numbers(steps(rows=w * h // 2), good)}
    for fault in ref.FAULTS:
        out[fault] = ref.joint_numbers(steps(fault=fault), good)
    return out
