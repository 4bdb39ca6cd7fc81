"""The comparison that decides `correct`: what the timed path produced,
held against the plain reference (benchmark/reference) at the timed sizes.

Render cells: a seeded sample of the window's waves and of their pixels.
The film a wave left minus the film it was given is that wave's sample of
each pixel (the weight channel exactly 1); the reference walks the same
pixels of the same wave from the raw grids and draws. A lane is off when a
channel differs by more than 1e-3 of the reference's value plus the film's
rounding: the reference follows the same draws, so a sound program agrees
on every lane but those a last-bit difference sends down another path.

Training cells: the reference takes the first steps itself from the same
starting parameters, views, targets and waves (forward walk, then the
replay's gradient, then Adam), and the program's loss at each, the
gradient its optimizer took at the first (from its state) and its
parameters' change over them are held to the reference's.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from . import roofline, scenes
from .reference import walk as ref


class Reading(NamedTuple):
    value: float
    limit: float


def sample_plan(seed: int, check: dict, npix: int):
    """(window wave positions, one pixel-id sample per position), drawn from the seed."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 0xC4EC])
    n_waves = min(check["waves"], check["within_waves"])
    positions = sorted(int(p) for p in rng.choice(check["within_waves"], size=n_waves, replace=False))
    pixels = [np.sort(rng.choice(npix, size=min(check["pixels"], npix), replace=False)) for _ in positions]
    return positions, pixels


def reference_volume(cfg, density, temperature, device, dtype, bloat=0.0):
    def g(x):
        return None if x is None else ref.Grid(x.data.to(device), x.origin, x.voxel, x.offset)

    return ref.Volume(g(density), scenes.transport(cfg), g(temperature), bloat=bloat, dtype=dtype)


def touched_tables(vol: ref.Volume) -> dict:
    X, Y, Z = vol.shape
    out = {"corners": torch.zeros(((X + 1) * (Y + 1) * (Z + 1),), dtype=torch.int32, device=vol.device),
           "bricks": torch.zeros((vol.bmaj.numel(),), dtype=torch.int32, device=vol.device)}
    if vol.emits:
        TX, TY, TZ = vol.tshape
        out["tcorners"] = torch.zeros(((TX + 1) * (TY + 1) * (TZ + 1),), dtype=torch.int32, device=vol.device)
    return out


def reference_waves(cfg, density, temperature, seed, waves: List[int], pixels, device, dtype=torch.float32,
                    measure=False):
    """The reference's samples (imaging_ratio * XYZ, float32 [n, 3]) of the
    given pixels of the given waves, and, with `measure`, the launch's work."""
    vol = reference_volume(cfg, density, temperature, device, dtype)
    W, H = cfg["output_size"]
    c = cfg["camera"]
    cam = ref.Pinhole(c["position"], c["look"], c["up"], c["vfov_deg"], W, H, device, dtype)
    pids = torch.cat([torch.as_tensor(p, dtype=torch.int64) for p in pixels]).to(device)
    streams = torch.cat([torch.full((len(p),), ref.stream_word(seed, w), dtype=torch.int64)
                         for w, p in zip(waves, pixels)]).to(device)
    o, d = cam.rays(pids, streams, 0.5 if cfg["use_jitter"] else 0.0)
    touched = touched_tables(vol) if measure else None
    res = ref.walk(vol, o, d, pids, streams, cfg["max_iters"], touched=touched)
    out = (c["imaging_ratio"] * res.L).float()
    work = None
    if measure:
        work = roofline.Work(lanes=W * H, lane_steps=float(res.steps.double().mean()) * W * H,
                             corners=int((touched["corners"] > 0).sum()), pairs=int((touched["bricks"] > 0).sum()),
                             tcorners=int((touched["tcorners"] > 0).sum()) if "tcorners" in touched else 0)
    return out, int(res.capped.sum()), work


def off_lanes(inc: torch.Tensor, after: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """[n] bool: lanes whose film increment `inc` [n, 4] is not the
    reference's sample `want` [n, 3] (weight 1, channels within 1e-3 plus
    the rounding of the film `after` [n, 4] they were added into)."""
    eps = torch.finfo(torch.float32).eps
    tol = 1e-3 * want.abs() + 4 * eps * after[:, :3].abs() + 1e-6
    return ((inc[:, :3] - want).abs() > tol).any(-1) | (inc[:, 3] != 1.0)


def film_increments(kept: dict, positions, device):
    """(each sampled lane's film increment [n, 4], the film after [n, 4])."""
    incs, afters = [], []
    for pos in positions:
        _, before, after = kept[pos]
        a = after.float()
        b = before.float() if before is not None else torch.zeros_like(a)
        incs.append((a - b).to(device))
        afters.append(a.to(device))
    return torch.cat(incs), torch.cat(afters)


def render_check(cfg, density, temperature, seed, kept, positions, pixels, device, n_capped, limits, measure=False):
    """{name: Reading} of a render cell, and the launch's work (measure)."""
    waves = [kept[p][0] for p in positions]
    inc, after = film_increments(kept, positions, device)
    want, ref_capped, work = reference_waves(cfg, density, temperature, seed, waves, pixels, device, measure=measure)
    off = off_lanes(inc, after, want)
    out = {
        "off_lanes": Reading(float(off.float().mean()), limits["off_lanes"]),
        "capped_lanes": Reading(float(n_capped + ref_capped), limits["capped_lanes"]),
    }
    return out, work


def render_control(cfg, density, temperature, seed, positions, pixels, waves, device, dtype=torch.bfloat16):
    """off_lanes of the reference computed in `dtype`, put in the program's place."""
    want, _, _ = reference_waves(cfg, density, temperature, seed, waves, pixels, device)
    low, _, _ = reference_waves(cfg, density, temperature, seed, waves, pixels, device, dtype=dtype)
    inc = torch.cat([low, torch.ones_like(low[:, :1])], -1)
    return float(off_lanes(inc, inc, want).float().mean())


# --------------------------------------------------------------- train -----

def reference_steps(cfg, mix, density, p0: torch.Tensor, targets: torch.Tensor, seed: int, steps: int, device,
                    dtype=torch.float32, measure=False, rows=None):
    """The reference's first `steps` train steps from parameters p0: (losses,
    the first step's gradient norm, the parameters' change norm after
    `steps`, the record's and replay's work of the first step if measured).
    rows: the first `rows` pixels of the batch only (a fault's reading)."""
    w, h = mix["pixels"]
    k = mix["samples_per_step"]
    n = rows or w * h
    ratio = cfg["camera"]["imaging_ratio"]
    K = cfg["worker_parameters"]["max_depth"] // 2 + 1
    cams = [ref.Pinhole(pos, (0.0, 0.0, 0.0), cfg["camera"]["up"], mix["vfov_deg"], w, h, device, dtype)
            for pos in scenes.ring_cameras(mix["views"], mix["ring_radius"])]
    p = p0.to(device=device, dtype=torch.float32).clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, mix["lr"]
    losses, gnorm, work = [], None, None
    pids1 = torch.arange(n, dtype=torch.int64, device=device)
    for i in range(steps):
        dens = torch.logaddexp(p, torch.zeros((), device=device))
        grid = ref.Grid(dens, density.origin, density.voxel, density.offset)
        vol = ref.Volume(grid, scenes.transport(cfg), bloat=0.1, dtype=dtype)
        pids = pids1.repeat(k)
        streams = torch.tensor([ref.stream_word(seed, (i * k + j) & 0xFFFFFFFF) for j in range(k)],
                               dtype=torch.int64, device=device).repeat_interleave(n)
        o, d = cams[i % len(cams)].rays(pids, streams, 0.5 if cfg["use_jitter"] else 0.0)
        touched = touched_tables(vol) if (measure and i == 0) else None
        fw = ref.walk(vol, o, d, pids, streams, mix["n_iters"], record_walks=K, touched=touched)
        Lk = ratio * fw.L.float().reshape(k, n, 3)
        diff = Lk.mean(0) - targets[i % len(cams)][:n].to(device)
        nq = float(n * 3)
        losses.append(float((diff * diff).sum()) / nq)
        g_lane = (2.0 * ratio / k) * diff.repeat(k, 1)
        rp = ref.walk(vol, o, d, pids, streams, mix["n_iters"], replay=(g_lane, fw.L, fw.t_final))
        grad = rp.grad * torch.sigmoid(p) / nq
        if i == 0:
            gnorm = float(grad.double().norm())
            if measure:
                lane_steps = float(fw.steps.double().sum())
                work = roofline.Work(lanes=n * k, lane_steps=lane_steps, corners=int((touched["corners"] > 0).sum()),
                                     pairs=int((touched["bricks"] > 0).sum()))
        m = b1 * m + (1 - b1) * grad
        v = b2 * v + (1 - b2) * grad * grad
        mh = m / (1 - b1 ** (i + 1))
        vh = v / (1 - b2 ** (i + 1))
        p = p - lr * mh / (torch.sqrt(vh) + eps)
    upd = float((p - p0.to(device)).double().norm())
    return losses, gnorm, upd, work


def gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else float("inf")


def train_numbers(prog_losses, prog_gnorm, prog_upd, ref_losses, ref_gnorm, ref_upd) -> Dict[str, float]:
    return {
        "loss_gap": max(gap(a, b) for a, b in zip(prog_losses, ref_losses)),
        "grad_norm_gap": gap(prog_gnorm, ref_gnorm),
        "update_norm_gap": gap(prog_upd, ref_upd),
    }
