"""Plain PyTorch reference of the emissive joint fit, written from the
published description of path-replay backpropagation (Vicini, Speierer and
Jakob 2021) and imported by nothing of the program.

A density grid and a temperature grid are recovered together: density =
softplus(log density), the temperature the raw adimensional grid (kelvin =
offset + scale * t), one Adam over both. The loss is the dual buffer: the k
samples of a pixel split into halves A and B, and sum((A - t) * (B - t)),
whose gradient carries no variance term.

`walk` is walk.py's walk (the same draws, free flight, events, NEE and
blackbody emission, in any float dtype) with two differences:
  - each lane's shadow walks are recorded in slots grown as the walks start
    (walk.py sizes them by max_depth, 500,001 a lane for the fire);
  - its replay returns the gradient of <g, L> with respect to the
    temperature grid as well, and adds the emission's own density term.
    At a camera-path real collision the emission p_a * le * B(T) (p_a =
    sigma_a * rho / sigma_maj) gives d/d rho_corner = sigma_a / sigma_maj
    * le * <g, B(T)> * w8 and d/d t_corner = p_a * le * <g, B'(T)> *
    temperature_scale * tw8, B' the slope of the table lerp that
    spectral.Blackbody reads (0 where it clamps), tw8 the trilinear weights
    through the temperature grid's own transform. The other density terms
    (the event's score, ratio tracking) are walk.py's.

`reference_steps` takes the first train steps of a `Fit` and `joint_numbers`
holds a program's readings to them. A `fault` plants a known error in the
reference, so that each can be shown to read not correct.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .spectral import RESOLUTION_K, Blackbody
from .walk import (BRICK, CAM, DONE, SHADOW, SUPER, Grid, Pinhole, Transport, Volume, _M32, _clip, _dot8, _f32,
                   _safe_inv, _trilinear_setup, init_lanes, pcg4d, stream_word, uniform)

LEAVES = ("density", "temperature")
# Faults planted in the reference: each must read not correct.
FAULTS = ("no_temperature_grad", "value_for_slope", "squared_error")
ADAM = (0.9, 0.999, 1e-8)  # beta1, beta2, eps: optax.adam's and torch.optim.Adam's defaults


def blackbody_slope(bb: Blackbody, kelvin: torch.Tensor) -> torch.Tensor:
    """d B / d kelvin [N, 3] of Blackbody's lookup: the slot's slope over the
    slot width inside the lerp's range, 0 where the T <= 0 guard or the clamp
    holds the value."""
    tc = torch.clamp(kelvin, 0.0, bb.t_cap)
    slot = torch.clamp(torch.floor(tc / RESOLUTION_K).long() + 1, 0, bb.n - 2)
    inside = (kelvin > 0.0) & (kelvin < bb.t_cap)
    return torch.where(inside[:, None], bb.slope[slot] / RESOLUTION_K, torch.zeros_like(bb.slope[slot]))


class WalkResult(NamedTuple):
    L: torch.Tensor  # [N, 3] XYZ radiance
    steps: torch.Tensor  # [N] steps each lane took
    capped: torch.Tensor  # [N] bool: still walking at max_iters
    t_final: Optional[torch.Tensor]  # [N, K] final transmittance of each started shadow walk (forward)
    grad_density: Optional[torch.Tensor] = None  # [X, Y, Z] d <g, L> / d density (replay)
    grad_temperature: Optional[torch.Tensor] = None  # [TX, TY, TZ] d <g, L> / d temperature (replay)


def walk(vol: Volume, o_world: torch.Tensor, d_world: torch.Tensor, pids: torch.Tensor, streams: torch.Tensor,
         max_iters: int, replay=None, touched: Optional[dict] = None, fault: str = "") -> WalkResult:
    """Walk every lane until it retires or has taken max_iters steps.

    Forward (replay None): the radiance, and t_final [N, K], K the most shadow
    walks a lane started. replay: (g [N, 3], L [N, 3], t_final [N, K]) of a
    recorded walk: walk again and return both gradients of <g, L>. touched:
    as walk.py's (int32 'corners', 'bricks', 'tcorners'), plus 'emissive', a
    one-element int64 count of camera-path real collisions (each reads the
    temperature and the blackbody table). fault: "value_for_slope" uses B(T)
    where the temperature gradient needs B'(T).
    """
    tp = vol.t
    dt = vol.dtype
    acc = torch.promote_types(dt, torch.float32)
    dev = vol.device
    N = o_world.shape[0]
    X, Y, Z = vol.shape
    BX, BY, BZ = vol.nb
    O = torch.tensor(vol.density.origin, device=dev, dtype=dt)
    box_hi = O + torch.tensor(vol.shape, device=dev, dtype=dt)
    voxel = vol.density.voxel
    inv_voxel = _f32(np.float32(1.0) / np.float32(voxel))
    sigma_t = _f32(tp.sigma_t)
    wi = torch.tensor(vol.wi, device=dev, dtype=dt)
    wi_inv = torch.tensor(vol.wi_inv, device=dev, dtype=dt)
    Li = torch.tensor(vol.Li, device=dev, dtype=dt)
    Linf = torch.tensor(vol.Linf, device=dev, dtype=dt)
    g = np.float32(tp.g)
    one, two = np.float32(1.0), np.float32(2.0)
    one_p_g, two_g, g2 = float(one + g), float(two * g), g * g
    one_m_g2, one_p_g2 = float(one - g2), float(one + g2)
    hg_num = _f32(np.float32(1.0 / (4.0 * math.pi)) * (one - g2))
    hg_den0, hg_c1 = one_p_g2, two_g
    dflat = vol.dpad.reshape(-1)
    if vol.emits:
        d_off = torch.tensor(vol.density.offset, device=dev, dtype=dt)
        t_off = torch.tensor(vol.temperature.offset, device=dev, dtype=dt)
        t_vox = torch.tensor(vol.temperature.voxel, device=dev, dtype=torch.float32).to(dt)
        t_org = torch.tensor(vol.temperature.origin, device=dev, dtype=dt)
        tflat = vol.tpad.reshape(-1)

    st = init_lanes(vol, o_world, d_world)
    st["pid"] = pids.to(torch.int64) & _M32
    st["strm"] = streams.to(torch.int64) & _M32
    st["lane"] = torch.arange(N, device=dev)
    out_L = torch.zeros((N, 3), device=dev, dtype=dt)
    out_steps = torch.zeros((N,), device=dev, dtype=torch.int64)
    out_capped = torch.zeros((N,), device=dev, dtype=torch.bool)
    t_final = grad = tgrad = None
    if replay is None:
        t_final = torch.zeros((N, 0), device=dev, dtype=dt)
    else:
        g_vec, L_tot, tf_rec = replay
        grad = torch.zeros(((X + 2) * (Y + 2) * (Z + 2),), device=dev, dtype=acc)
        if vol.emits:
            TX, TY, TZ = vol.tshape
            tgrad = torch.zeros(((TX + 2) * (TY + 2) * (TZ + 2),), device=dev, dtype=acc)
        st["gsuf"] = (g_vec.to(dt) * L_tot.to(dt)).sum(-1)  # <g, L> still to come
        st["gLi"] = (g_vec.to(dt) * Li).sum(-1)
        st["gv"] = g_vec.to(dt)

    def retire(keep):
        done = ~keep
        lanes = st["lane"][done]
        out_L[lanes] = st["L"][done]
        out_steps[lanes] = st["ctr"][done]
        out_capped[lanes] = st["mode"][done] != DONE
        for k in list(st):
            st[k] = st[k][keep]

    it = 0
    while True:
        if it % 8 == 0:
            alive = (st["mode"] != DONE) & (st["ctr"] < max_iters)
            n_alive = int(alive.sum())
            if n_alive < alive.shape[0]:
                retire(alive)
            if n_alive == 0:
                break
            if t_final is not None:
                # a walk takes two iterations at least: 4 more can start before the next look
                need = int(st["wc"].max()) + 4
                if need > t_final.shape[1]:
                    t_final = torch.cat([t_final, t_final.new_zeros((N, need - t_final.shape[1]))], 1)
        it += 1
        active = (st["mode"] != DONE) & (st["ctr"] < max_iters)
        in_cam = active & (st["mode"] == CAM)
        in_shw = active & (st["mode"] == SHADOW)
        o, d, inv, t = st["o"], st["d"], st["inv"], st["t"]

        r = pcg4d(st["pid"], st["strm"], st["ctr"], torch.zeros_like(st["ctr"]))
        u0, u1, u2, u3 = (uniform(x, dt) for x in r)

        # ---- free flight in the carried segment ----
        has_seg = st["t_seg"] > t
        rsig = 1.0 / torch.clamp(st["sig_seg"], min=1e-20)
        t_cand = t + (-torch.log1p(-u0) * rsig) * inv_voxel
        collide = active & has_seg & (st["sig_seg"] > 0) & (t_cand < st["t_seg"])
        t_next = torch.where(has_seg, st["t_seg"], t)
        exited = active & ~collide & (t_next >= st["t_exit"] - 1e-6)
        fetch = active & ~collide & ~exited

        t_gather = torch.where(collide, t_cand, t_next + 1e-3)
        pc = o + d * t_gather[:, None]
        lp = pc - O
        b = torch.floor(lp / BRICK).long()
        b_valid = (b[:, 0] >= 0) & (b[:, 0] < BX) & (b[:, 1] >= 0) & (b[:, 1] < BY) & (b[:, 2] >= 0) & (b[:, 2] < BZ)
        b_flat = (torch.clamp(b[:, 0], 0, BX - 1) * BY + torch.clamp(b[:, 1], 0, BY - 1)) * BZ \
            + torch.clamp(b[:, 2], 0, BZ - 1)
        cidx, w8, valid = _trilinear_setup(lp, vol.shape)
        rho = torch.where(valid & collide, _dot8(dflat[cidx], w8), torch.zeros_like(t))
        bmaj = torch.where(b_valid & fetch, vol.bmaj[b_flat], torch.zeros_like(t))
        smaj = torch.where(b_valid & fetch, vol.smaj[b_flat], torch.zeros_like(t))
        if touched is not None:
            base = cidx[:, 0]  # the padded index of corner (0, 0, 0) = base voxel + 1
            bx, rem = base // ((Y + 2) * (Z + 2)), base % ((Y + 2) * (Z + 2))
            by, bz = rem // (Z + 2), rem % (Z + 2)
            row = (bx * (Y + 1) + by) * (Z + 1) + bz
            touched["corners"].index_add_(0, row, (collide & valid).int())
            touched["bricks"].index_add_(0, b_flat, (fetch & b_valid).int())

        # ---- the next segment: brick or superbrick ----
        extra = (smaj - bmaj) * sigma_t * float(BRICK * SUPER) * voxel
        use_super = extra <= tp.super_tau
        cs = torch.where(use_super, 64.0, 8.0).to(dt)
        inv_cs = torch.where(use_super, 1.0 / 64.0, 1.0 / 8.0).to(dt)
        cl = torch.floor(lp * inv_cs[:, None]) * cs[:, None] + O
        t_cell = torch.maximum((cl - o) * inv, ((cl + cs[:, None]) - o) * inv).amin(-1)
        t_seg_f = torch.maximum(torch.minimum(t_cell, st["t_exit"]), t_next + 2e-3)
        sig_seg_f = torch.where(use_super, smaj, bmaj) * sigma_t
        real_col = collide & (rho > 0)
        zero_col = collide & ~(rho > 0)

        # ---- camera collision: emission, then the event ----
        cam_col = in_cam & real_col
        p_a = tp.sigma_a * rho * rsig
        p_s = tp.sigma_s * rho * rsig
        p_n = torch.clamp(1.0 - p_a - p_s, min=0.0)
        L = st["L"]
        demis = None
        if vol.emits:
            tl = ((pc * voxel + d_off) - t_off) / t_vox - t_org
            tidx, tw, tvalid = _trilinear_setup(tl, vol.tshape)
            temp = torch.where(tvalid & cam_col, _dot8(tflat[tidx], tw), torch.zeros_like(t))
            kelvin = temp * tp.temperature_scale + tp.temperature_offset
            bbv = vol.blackbody(kelvin)
            emit = (p_a * tp.le_scale)[:, None] * bbv
            L = L + torch.where(cam_col[:, None], emit, torch.zeros_like(emit))
            if touched is not None:
                tb = tidx[:, 0]
                TY, TZ = vol.tshape[1], vol.tshape[2]
                tx, trem = tb // ((TY + 2) * (TZ + 2)), tb % ((TY + 2) * (TZ + 2))
                trow = (tx * (TY + 1) + trem // (TZ + 2)) * (TZ + 1) + trem % (TZ + 2)
                touched["tcorners"].index_add_(0, trow, (cam_col & tvalid).int())
                touched["emissive"] += cam_col.sum()
            if replay is not None:
                # d emission / d rho_corner and d emission / d t_corner, per unit trilinear weight
                demis = torch.where(cam_col, tp.sigma_a * rsig * tp.le_scale * (st["gv"] * bbv).sum(-1),
                                    torch.zeros_like(rho))
                slope = bbv if fault == "value_for_slope" else blackbody_slope(vol.blackbody, kelvin)
                tcoef = torch.where(cam_col & tvalid,
                                    p_a * tp.le_scale * (st["gv"] * slope).sum(-1) * tp.temperature_scale,
                                    torch.zeros_like(rho))
                tgrad.index_add_(0, tidx.reshape(-1), (tcoef[:, None] * tw).reshape(-1).to(acc))
        xv = u1 * (p_n + p_a + p_s)
        event = torch.where(xv <= p_n, 0, torch.where(xv <= p_n + p_a, 1, 2))
        cam_null = cam_col & (event == 0)
        cam_abs = cam_col & (event == 1)
        cam_scat = cam_col & (event == 2)

        if replay is not None:
            # the score of the event times <g, radiance after it> (this collision's emission is in L already)
            score = torch.where(cam_null, -(tp.sigma_a + tp.sigma_s) * rsig / torch.clamp(p_n, min=1e-20),
                                torch.where(cam_scat, 1.0 / torch.clamp(rho, min=1e-20), torch.zeros_like(rho)))
            coef = score * (st["gsuf"] - (st["gv"] * L).sum(-1))
            if demis is not None:
                coef = coef + demis
            # ratio tracking: T_final * phase * <g, Li> * d log(sigma_n) / d rho
            shw_hit = in_shw & real_col
            slot = torch.clamp(st["wc"] - 1, 0, max(tf_rec.shape[1] - 1, 0))
            tfin = tf_rec[st["lane"], slot].to(dt) if tf_rec.shape[1] else torch.zeros_like(t)
            sig_n = st["sig_seg"] - sigma_t * rho
            coef = coef + torch.where(shw_hit & (sig_n > 0) & (tfin > 0),
                                      st["phase"] * tfin * st["gLi"] * (-sigma_t) / torch.clamp(sig_n, min=1e-20),
                                      torch.zeros_like(rho))
            coef = torch.where(valid, coef, torch.zeros_like(coef))
            grad.index_add_(0, cidx.reshape(-1), (coef[:, None] * w8).reshape(-1).to(acc))

        phase_old = st["phase"]
        # Henyey-Greenstein redirect of the camera path around d
        denom = one_p_g - two_g * u2
        sqr = one_m_g2 / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
        cos_t = (one_p_g2 - sqr * sqr) / two_g if abs(g) >= 1e-3 else 1.0 - 2.0 * u2
        sin_t = torch.clamp(torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0)), -1.0, 1.0)
        phi = _f32(2.0 * math.pi) * u3
        loc = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.clamp(cos_t, -1.0, 1.0)], -1)
        loc = loc / torch.sqrt((loc * loc).sum(-1, keepdim=True))
        dx, dy, dz = d.unbind(-1)
        sgn = torch.where(dz >= 0, 1.0, -1.0).to(dt)
        a = -1.0 / (sgn + dz)
        bb = dx * dy * a
        v2 = torch.stack([1.0 + sgn * a * dx * dx, sgn * bb, -sgn * dx], -1)
        v3 = torch.stack([bb, sgn + a * dy * dy, -dy], -1)
        new_dir = loc[:, 0:1] * v2 + loc[:, 1:2] * v3 + loc[:, 2:3] * d
        cw = (d * wi).sum(-1)
        den = hg_den0 + hg_c1 * cw
        phase_new = hg_num / (den * torch.sqrt(torch.clamp(den, min=1e-12)))
        pd = torch.where(cam_scat[:, None], new_dir, st["pd"])
        po = torch.where(cam_scat[:, None], pc, st["po"])
        phase = torch.where(cam_scat, phase_new, phase_old)
        depth = torch.where(cam_scat, st["depth"] + 2, st["depth"])

        # ---- shadow collision: ratio tracking with Russian roulette ----
        shw_col = in_shw & real_col
        sigma_n = torch.clamp(st["sig_seg"] - sigma_t * rho, min=0.0)
        T_after = st["T"] * (sigma_n * rsig)
        rr = T_after <= 0.05
        T_after = torch.where(rr & (u1 < 0.75), torch.zeros_like(T_after), torch.where(rr, T_after / 0.25, T_after))
        T_new = torch.where(shw_col, T_after, st["T"])
        shadow_finish = (in_shw & exited) | (shw_col & (T_new <= 0))
        L = L + torch.where(shadow_finish[:, None], (phase_old * T_new)[:, None] * Li, torch.zeros_like(L))
        if t_final is not None:
            rec = shadow_finish & (st["wc"] >= 1)
            at = (st["lane"], torch.clamp(st["wc"] - 1, min=0))
            t_final.index_put_(at, torch.where(rec, T_new, t_final[at]))

        # ---- resume or retire ----
        start_shadow = cam_scat if vol.nee else torch.zeros_like(cam_scat)
        resume = shadow_finish if vol.nee else (shadow_finish | cam_scat)
        pinv = _safe_inv(pd)
        t0n, t1n, hitn = _clip(torch.where(start_shadow[:, None], pc, po),
                               torch.where(start_shadow[:, None], wi_inv.expand_as(pd), pinv), O, box_hi)
        depth_ok = depth < tp.max_depth
        resume_ok = resume & hitn & depth_ok
        resume_escape = resume & (~hitn | ~depth_ok)
        start_ok = start_shadow & hitn
        shadow_miss = start_shadow & ~hitn
        L = L + torch.where(shadow_miss[:, None], phase[:, None] * Li, torch.zeros_like(L))
        t0p, t1p, hitp = _clip(po, pinv, O, box_hi)
        miss_ok = shadow_miss & hitp & depth_ok
        miss_escape = shadow_miss & (~hitp | ~depth_ok)
        done_inf = (in_cam & exited) | resume_escape | miss_escape
        L = L + torch.where(done_inf[:, None], Linf.expand_as(L), torch.zeros_like(L))

        mode = st["mode"]
        mode = torch.where(done_inf | cam_abs, DONE, mode)
        mode = torch.where(start_ok, SHADOW, mode)
        mode = torch.where(resume_ok | miss_ok, CAM, mode).to(torch.int32)

        back = resume_ok | miss_ok
        o_new = torch.where(start_ok[:, None], pc, torch.where(back[:, None], po, o))
        d_new = torch.where(start_ok[:, None], wi.expand_as(d), torch.where(back[:, None], pd, d))
        inv_new = torch.where(start_ok[:, None], wi_inv.expand_as(d), torch.where(back[:, None], pinv, inv))
        t_new = torch.where(start_ok | resume_ok, t0n, torch.where(miss_ok, t0p, t))
        t_exit = torch.where(start_ok | resume_ok, t1n, torch.where(miss_ok, t1p, st["t_exit"]))
        plain_adv = cam_null | zero_col | (in_shw & real_col & ~shadow_finish)
        t_new = torch.where(plain_adv, t_cand, t_new)
        t_new = torch.where(fetch, t_next, t_new)
        new_ray = start_ok | resume_ok | miss_ok
        sig_seg = torch.where(new_ray, torch.zeros_like(t), torch.where(fetch, sig_seg_f, st["sig_seg"]))
        t_seg = torch.where(new_ray, t_new, torch.where(fetch, t_seg_f, st["t_seg"]))
        T = torch.where(start_ok, torch.ones_like(T_new), T_new)

        st.update(o=o_new, d=d_new, inv=inv_new, t=t_new, t_exit=t_exit, sig_seg=sig_seg, t_seg=t_seg, L=L,
                  po=po, pd=pd, T=T, phase=phase, depth=depth, mode=mode,
                  ctr=st["ctr"] + active.long(), wc=st["wc"] + start_ok.long())
    res = WalkResult(L=out_L, steps=out_steps, capped=out_capped, t_final=t_final)
    if grad is not None:
        res = res._replace(grad_density=grad.view(X + 2, Y + 2, Z + 2)[1:-1, 1:-1, 1:-1].contiguous())
        if tgrad is not None:
            TX, TY, TZ = vol.tshape
            res = res._replace(grad_temperature=tgrad.view(TX + 2, TY + 2, TZ + 2)[1:-1, 1:-1, 1:-1].contiguous())
    return res


# ----------------------------------------------------------- the fit -------

@dataclasses.dataclass(frozen=True)
class Fit:
    """The job: what a train step renders and how it updates."""
    transport: Transport
    cameras: Sequence  # camera positions, one view a step
    look: Sequence[float]
    up: Sequence[float]
    vfov_deg: float
    pixels: Sequence[int]  # (width, height)
    imaging_ratio: float
    jitter: bool
    samples: int  # k samples a pixel a step, halves A and B of k / 2
    n_iters: int
    lr: float
    bloat: float  # majorant slack


class Steps(NamedTuple):
    losses: List[float]
    grad_norms: Dict[str, float]  # each leaf's first-step gradient norm
    update_norms: Dict[str, float]  # each leaf's change over the steps
    counts: Optional[dict]  # the first step's forward walk, with `measure`
    first: Optional[Dict[str, torch.Tensor]] = None  # each leaf's first-step gradient
    updated: Optional[Dict[str, torch.Tensor]] = None  # each leaf after the steps


def cotangent(L: torch.Tensor, target: torch.Tensor, k: int, ratio: float, dual: bool = True):
    """(the loss's sum, its gradient with respect to each lane's radiance [k * n, 3])
    of a batch whose radiance L [k * n, 3] holds k samples of n pixels, sample
    by sample. Dual buffer: sum((A - t) * (B - t)), A and B the film means of
    the first and second k / 2 samples; a lane of A gets (ratio / (k / 2)) *
    (B - t), one of B (ratio / (k / 2)) * (A - t). Else the squared error of
    the mean of all k."""
    n = target.shape[0]
    Lk = ratio * L.float().reshape(k, n, 3)
    if not dual:
        diff = Lk.mean(0) - target
        return float((diff * diff).sum()), (2.0 * ratio / k) * diff.repeat(k, 1)
    h = k // 2
    a = Lk[:h].mean(0) - target
    b = Lk[h:].mean(0) - target
    return float((a * b).sum()), (ratio / h) * torch.cat([b.repeat(h, 1), a.repeat(k - h, 1)])


def _touched(vol: Volume) -> dict:
    X, Y, Z = vol.shape
    TX, TY, TZ = vol.tshape
    dev = vol.device
    return {"corners": torch.zeros(((X + 1) * (Y + 1) * (Z + 1),), dtype=torch.int32, device=dev),
            "bricks": torch.zeros((vol.bmaj.numel(),), dtype=torch.int32, device=dev),
            "tcorners": torch.zeros(((TX + 1) * (TY + 1) * (TZ + 1),), dtype=torch.int32, device=dev),
            "emissive": torch.zeros((1,), dtype=torch.int64, device=dev)}


def reference_steps(fit: Fit, density: Grid, temperature: Grid, p0: torch.Tensor, t0: torch.Tensor,
                    targets: torch.Tensor, seed: int, steps: int, device, dtype=torch.float32, rows=None,
                    fault: str = "", measure: bool = False) -> Steps:
    """The first `steps` train steps of the fit from log density p0 and
    temperature t0 on the grids' transforms: step i renders view i mod
    views, k samples of each pixel under stream words (seed, i * k + j),
    then the replay's gradients, then Adam over both leaves. rows: the first
    `rows` pixels only. fault: one of FAULTS ("no_temperature_grad" drops the
    temperature gradient, "value_for_slope" uses B(T) for B'(T),
    "squared_error" the plain loss in place of the dual buffer). measure:
    the first step's forward walk counts lanes, lane-steps, the distinct
    density and temperature corner sets, majorant pairs and camera-path
    real collisions. float32 matrix products run in float32 (no TF32) while
    it runs, as the reference is stated."""
    keep = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _steps(fit, density, temperature, p0, t0, targets, seed, steps, device, dtype, rows, fault, measure)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def _steps(fit, density, temperature, p0, t0, targets, seed, steps, device, dtype, rows, fault, measure) -> Steps:
    w, h = fit.pixels
    k = fit.samples
    n = rows or w * h
    cams = [Pinhole(pos, fit.look, fit.up, fit.vfov_deg, w, h, device, dtype) for pos in fit.cameras]
    params = {"density": p0.to(device=device, dtype=torch.float32).clone(),
              "temperature": t0.to(device=device, dtype=torch.float32).clone()}
    m = {q: torch.zeros_like(v) for q, v in params.items()}
    v2 = {q: torch.zeros_like(v) for q, v in params.items()}
    b1, b2, eps = ADAM
    losses, first, counts = [], {}, None
    pids1 = torch.arange(n, dtype=torch.int64, device=device)
    pids = pids1.repeat(k)
    for i in range(steps):
        p = params["density"]
        dens = torch.logaddexp(p, torch.zeros((), device=device))
        vol = Volume(Grid(dens, density.origin, density.voxel, density.offset), fit.transport,
                     Grid(params["temperature"], temperature.origin, temperature.voxel, temperature.offset),
                     bloat=fit.bloat, dtype=dtype)
        streams = torch.tensor([stream_word(seed, (i * k + j) & _M32) for j in range(k)],
                               dtype=torch.int64, device=device).repeat_interleave(n)
        o, d = cams[i % len(cams)].rays(pids, streams, 0.5 if fit.jitter else 0.0)
        touched = _touched(vol) if (measure and i == 0) else None
        fw = walk(vol, o, d, pids, streams, fit.n_iters, touched=touched)
        nq = float(n * 3)
        sq, g_lane = cotangent(fw.L, targets[i % len(cams)][:n].to(device), k, fit.imaging_ratio,
                               dual=fault != "squared_error")
        losses.append(sq / nq)
        rp = walk(vol, o, d, pids, streams, fit.n_iters, replay=(g_lane, fw.L, fw.t_final), fault=fault)
        grads = {"density": rp.grad_density.float() * torch.sigmoid(p) / nq,
                 "temperature": rp.grad_temperature.float() / nq}
        if fault == "no_temperature_grad":
            grads["temperature"] = torch.zeros_like(grads["temperature"])
        if i == 0:
            first = grads
            if touched is not None:
                counts = {"lanes": n * k, "lane_steps": float(fw.steps.double().sum()),
                          **{c: int((touched[c] > 0).sum()) for c in ("corners", "bricks", "tcorners")},
                          "emissive": float(touched["emissive"].sum())}
        for q, x in grads.items():
            m[q] = b1 * m[q] + (1 - b1) * x
            v2[q] = b2 * v2[q] + (1 - b2) * x * x
            mh = m[q] / (1 - b1 ** (i + 1))
            vh = v2[q] / (1 - b2 ** (i + 1))
            params[q] = params[q] - fit.lr * mh / (torch.sqrt(vh) + eps)
    start = {"density": p0, "temperature": t0}
    upd = {q: float((params[q] - start[q].to(device)).double().norm()) for q in LEAVES}
    gnorms = {q: float(x.double().norm()) for q, x in first.items()}
    return Steps(losses, gnorms, upd, counts, first, params)


def gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else float("inf")


def joint_numbers(prog: Steps, ref: Steps) -> Dict[str, float]:
    """The numbers that decide `correct`: each |program - reference| / reference."""
    out = {"loss_gap": max(gap(a, b) for a, b in zip(prog.losses, ref.losses))}
    for q in LEAVES:
        out["grad_norm_gap." + q] = gap(prog.grad_norms[q], ref.grad_norms[q])
    for q in LEAVES:
        out["update_norm_gap." + q] = gap(prog.update_norms[q], ref.update_norms[q])
    return out
