"""Wavefront delta-tracking integrator: the plain PyTorch path.

Port of volume_path_tracer_tpu/render/integrator.py. Each
step advances every lane by one tracking event:

    brick/superbrick segment advance | exponential free flight | collision

with per-lane modes making the loop a state machine:

    CAM     delta tracking of the camera path: blackbody emission at every
            real collision (weighted by p_a), then a {null, absorb, scatter}
            event with p_n clamped at 0.
    SHADOW  ratio tracking of the next-event shadow ray toward the distant
            light, Russian roulette below T = 0.05 (q = 0.75). On completion
            the lane resumes its camera path from the scatter point.
    DONE    retired (absorbed, escaped, or out of depth budget).

This module is the CPU path and the reference the CUDA kernel
(render/megakernel.py, csrc/trace_lanes.cu) is held against: make_step is
the one plain step of the port. Expressions keep the JAX package's
operation order, with one exception shared with the kernel: the quotients
by the segment's majorant go through one reciprocal, and the quotient by the
voxel size through its float32 reciprocal (last-bit differences from the
JAX step, which the tests' tolerances cover).

Differentiability: the same step runs under torch autograd in
trace_rays_diff, a bounded loop of checkpointed steps (the oracle of the
replay gradient, diff/prb.py). Gradients flow through the trilinear density
and temperature samples, the ratio-tracking weights and the emission term;
majorants and event selections stay detached, and each discrete event
carries the score factor p_e / detach(p_e) in `wscore` (1.0 in value, d log
p_e in gradient).

Draws are keyed on each lane's own counter `ctr` (== the global iteration,
since every lane steps every iteration), so compacting retired lanes away,
or looping one lane on its own, gives every lane the same path.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..grids.grid import corner_row_index, dot8, sample_trilinear_local, sample_trilinear_rows, trilinear_weights
from ..grids.majorant import BRICK, SUPER
from ..models.medium import Medium
from ..ops.phase import henyey_greenstein, sample_henyey_greenstein
from ..utils import rng as vrng
from ..utils.config import VolumeParameters, WorkerParameters
from ..utils.spectral import blackbody_pairs, blackbody_radiation_xyz_from_pairs

# Lane modes
CAM = 0
SHADOW = 1
DONE = 2

_TINY = 1e-20
_LOOKAHEAD = 1e-3  # voxel units: gather point past a segment boundary
# Superbrick-opportunism threshold: a crossing takes a whole 64-voxel
# superbrick segment under the superbrick majorant when the expected extra
# null collisions (smaj - bmaj) * sigma_t * 64 * voxel stay below it. Any
# value is unbiased; it trades segment crossings against null collisions.
_SUPER_TAU = 8.0


def emission_enabled(medium: Medium, params: "IntegratorParams") -> bool:
    """True when the medium emits: temperature grid present AND le_scale != 0."""
    return medium.has_temperature and params.le_scale != 0.0


@dataclasses.dataclass(frozen=True)
class IntegratorParams:
    """Scene transport parameters (hashable, closed over by the step)."""

    sigma_a: float
    sigma_s: float
    hg_g: float
    le_scale: float
    temperature_offset: float
    temperature_scale: float
    infinite_xyz: Tuple[float, float, float]
    infinite_multiplier: float
    distant_xyz: Tuple[float, float, float]
    distant_multiplier: float
    distant_inv_direction: Tuple[float, float, float]
    max_depth: int
    max_iters: int = 8192
    super_tau: float = _SUPER_TAU

    @property
    def sigma_t(self) -> float:
        return self.sigma_a + self.sigma_s

    @property
    def nee_enabled(self) -> bool:
        # sample_Ld early-outs on exactly-zero Li (worker.cpp:57).
        return any(c * self.distant_multiplier != 0.0 for c in self.distant_xyz)

    @staticmethod
    def from_config(
        vol: VolumeParameters, worker: WorkerParameters, max_iters: int = 8192
    ) -> "IntegratorParams":
        return IntegratorParams(
            sigma_a=vol.sigma_a,
            sigma_s=vol.sigma_s,
            hg_g=vol.henyey_greenstein_g,
            le_scale=vol.le_scale,
            temperature_offset=vol.temperature_offset,
            temperature_scale=vol.temperature_scale,
            infinite_xyz=worker.infinite_light.xyz,
            infinite_multiplier=worker.infinite_light.multiplier,
            distant_xyz=worker.distant_light.xyz,
            distant_multiplier=worker.distant_light.multiplier,
            distant_inv_direction=worker.distant_light.inv_direction,
            max_depth=worker.max_depth,
            max_iters=max_iters,
        )


class RayState(NamedTuple):
    """SoA wavefront state; every field is [N] or [N, 3]."""

    o: torch.Tensor  # [N,3] ray origin, density-grid index space
    d: torch.Tensor  # [N,3] unit direction
    t: torch.Tensor  # [N] current parameter, voxel units
    t_exit: torch.Tensor  # [N] bbox exit parameter of the current ray
    sig_seg: torch.Tensor  # [N] world-unit majorant sigma of the current segment
    t_seg: torch.Tensor  # [N] segment end; t_seg <= t means no segment
    L: torch.Tensor  # [N,3] accumulated XYZ radiance
    wscore: torch.Tensor  # [N] score factor (1.0 in a forward render)
    depth: torch.Tensor  # [N] int32 path depth (+2 per scatter)
    mode: torch.Tensor  # [N] int32 CAM/SHADOW/DONE
    terminated: torch.Tensor  # [N] bool (absorbed)
    pend_o: torch.Tensor  # [N,3] camera-resume origin (scatter point)
    pend_d: torch.Tensor  # [N,3] camera-resume direction (HG sample)
    T_ray: torch.Tensor  # [N] shadow-ray transmittance
    phase_val: torch.Tensor  # [N] HG(w . wi) recorded at scatter time
    ctr: torch.Tensor  # [N] int32 per-lane draw counter (+1 per step)


def _f32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| floored at 1e-12, and 1e12 where d == 0 (sign(0) = 0)."""
    mag = torch.clamp(torch.abs(d), min=1e-12)
    return torch.sign(d) * (1.0 / mag) + torch.where(d == 0.0, 1e12, 0.0)


def clip_ray(o, d, lo, hi, t_min=1e-4):
    """Slab-clip rays [N,3] against box [lo, hi]; returns (t0, t1, hit)."""
    inv = _safe_inv(d)
    ta = (lo - o) * inv
    tb = (hi - o) * inv
    t_lo = torch.minimum(ta, tb).amax(dim=-1)
    t_hi = torch.maximum(ta, tb).amin(dim=-1)
    t0 = torch.clamp(t_lo, min=t_min)
    return t0, t_hi, t0 < t_hi


def _cell_exit_t(o, d, cell_lo, cell_hi):
    """Exit parameter of the axis-aligned cell [cell_lo, cell_hi] (per ray)."""
    inv = _safe_inv(d)
    ta = (cell_lo - o) * inv
    tb = (cell_hi - o) * inv
    return torch.maximum(ta, tb).amin(dim=-1)


def inv_voxel(voxel_size: float) -> float:
    """1 / voxel_size rounded to float32, the factor both the plain step and
    the CUDA kernel multiply by (a division is the longest link of the
    kernel's per-step chain)."""
    return float(np.float32(1.0) / np.float32(voxel_size))


class TravOut(NamedTuple):
    """Per-iteration traversal results. All fields are [N] or [N, 3]."""

    collide: torch.Tensor  # collision sampled inside the current segment
    exited: torch.Tensor  # crossed past the bbox exit
    fetch: torch.Tensor  # crossing lanes that install a fresh segment
    t_cand: torch.Tensor  # free-flight candidate parameter
    t_next: torch.Tensor  # next segment start for crossing lanes
    p_col: torch.Tensor  # [N,3] gather point (collision or lookahead)
    rho: torch.Tensor  # trilinear density at p_col (collide lanes)
    rsig: torch.Tensor  # 1 / max(sig_seg, TINY): one reciprocal for the step's quotients
    sigma_maj: torch.Tensor  # current segment's majorant sigma (raw)
    sig_seg_f: torch.Tensor  # freshly derived segment majorant (fetch lanes)
    t_seg_f: torch.Tensor  # freshly derived segment end (fetch lanes)
    use_super: torch.Tensor  # fetch used the superbrick level
    cell_lo: torch.Tensor  # [N,3] DDA cell bounds (debug channel)
    cell_sz: torch.Tensor  # [N] DDA cell size (debug channel)
    real_col: torch.Tensor  # collide with rho > 0
    zero_col: torch.Tensor  # collide with rho <= 0 (silent advance)
    temp_adim: Optional[torch.Tensor] = None  # temperature from 16-wide rows


def make_traversal(medium: Medium, params: IntegratorParams):
    """One tracking event per lane: free flight in the carried segment, THE
    row gather (corner row at a collision, majorant row at a crossing's
    lookahead point), and the next segment's derivation.

    Returns traverse(o, d, t, t_exit, sig_seg, t_seg, active, u0) -> TravOut.
    """
    dgrid = medium.density
    dev = dgrid.device
    O = _f32(dgrid.origin_ijk, dev)
    voxel = dgrid.voxel_size
    voxel_inv = inv_voxel(voxel)
    sigma_t = params.sigma_t

    maj_rows = medium.majorants.rows
    BX, BY, BZ = medium.majorants.brick_maj.shape
    fused = medium.density_rows

    def traverse(o, d, t, t_exit, sig_seg, t_seg, active, u0) -> TravOut:
        has_seg = t_seg > t
        rsig = 1.0 / torch.clamp(sig_seg, min=_TINY)
        dt_w = -torch.log1p(-u0) * rsig  # vrng.sample_exponential, through the reciprocal
        t_cand = t + dt_w * voxel_inv
        collide = active & has_seg & (sig_seg > 0.0) & (t_cand < t_seg)

        cross = active & (~collide)
        t_next = torch.where(has_seg, t_seg, t)
        exited = cross & (t_next >= t_exit - 1e-6)
        fetch = cross & (~exited)

        t_gather = torch.where(collide, t_cand, t_next + _LOOKAHEAD)
        p_col = o + d * t_gather[:, None]
        lp = p_col - O
        bb = torch.floor(lp / BRICK).to(torch.int64)
        bi, bj, bk = bb[:, 0], bb[:, 1], bb[:, 2]
        b_valid = (bi >= 0) & (bi < BX) & (bj >= 0) & (bj < BY) & (bk >= 0) & (bk < BZ)
        b_flat = (
            torch.clamp(bi, 0, BX - 1) * BY + torch.clamp(bj, 0, BY - 1)
        ) * BZ + torch.clamp(bk, 0, BZ - 1)
        temp_adim = None
        if fused is not None:
            X, Y, Z = dgrid.shape
            n_corner_rows = (X + 1) * (Y + 1) * (Z + 1)
            i0 = torch.floor(lp).to(torch.int64)
            f = lp - i0.to(lp.dtype)
            base, valid = corner_row_index(dgrid.shape, i0)
            idx = torch.where(collide, base, n_corner_rows + b_flat)
            row = fused[torch.clamp(idx, 0, fused.shape[0] - 1)]  # [N, 8 or 16]
            w8 = trilinear_weights(f)
            rho = torch.where(valid, dot8(row[:, :8], w8), 0.0)
            bmaj = torch.where(b_valid, row[:, 0], 0.0)
            smaj = torch.where(b_valid, row[:, 1], 0.0)
            if fused.shape[1] >= 16:
                temp_adim = torch.where(valid, dot8(row[:, 8:16], w8), 0.0)
        else:
            rho = sample_trilinear_local(dgrid.data, lp)
            both = maj_rows[torch.clamp(b_flat, 0, maj_rows.shape[0] - 1)]
            bmaj = torch.where(b_valid, both[:, 0], 0.0)
            smaj = torch.where(b_valid, both[:, 1], 0.0)

        extra = (smaj - bmaj) * sigma_t * float(BRICK * SUPER) * voxel
        use_super = extra <= params.super_tau
        cell_sz = torch.where(use_super, float(BRICK * SUPER), float(BRICK))
        cell_lo = torch.floor(lp / cell_sz[:, None]) * cell_sz[:, None] + O
        cell_hi = cell_lo + cell_sz[:, None]
        t_cell = _cell_exit_t(o, d, cell_lo, cell_hi)
        t_seg_f = torch.minimum(t_cell, t_exit)
        t_seg_f = torch.maximum(t_seg_f, t_next + 2 * _LOOKAHEAD)
        sig_seg_f = torch.where(use_super, smaj, bmaj) * sigma_t

        rho_pos = rho > 0.0
        return TravOut(
            collide=collide, exited=exited, fetch=fetch, t_cand=t_cand, t_next=t_next,
            p_col=p_col, rho=rho, rsig=rsig, sigma_maj=sig_seg,
            sig_seg_f=sig_seg_f, t_seg_f=t_seg_f, use_super=use_super,
            cell_lo=cell_lo, cell_sz=cell_sz, real_col=collide & rho_pos,
            zero_col=collide & (~rho_pos), temp_adim=temp_adim,
        )

    return traverse


def temperature_local(medium: Medium, p_col):
    """Density-index-space points p_col [N, 3] in the temperature grid's
    local coordinates, mapped world -> temperature index through the
    temperature grid's OWN transform (the reference's worker.cpp:153-155)."""
    dgrid = medium.density
    tgrid = medium.temperature
    dev = p_col.device
    p_world = p_col * dgrid.voxel_size + _f32(dgrid.world_offset, dev)
    tp = tgrid.world_to_index(p_world)
    return tp - _f32(tgrid.origin_ijk, dev)


def sample_temperature_kelvin(medium: Medium, params: IntegratorParams, p_col, return_local: bool = False):
    """Trilinear temperature (kelvin) at density-index-space points p_col,
    through the temperature grid's own transform (temperature_local).
    return_local=True returns (kelvin, local coordinates)."""
    tgrid = medium.temperature
    tp_local = temperature_local(medium, p_col)
    if medium.temperature_rows is not None:
        temp_adim = sample_trilinear_rows(medium.temperature_rows, tgrid.shape, tp_local)
    else:
        temp_adim = sample_trilinear_local(tgrid.data, tp_local)
    temp_k = temp_adim * params.temperature_scale + params.temperature_offset
    return (temp_k, tp_local) if return_local else temp_k


def light_constants(params: IntegratorParams, device="cpu"):
    """(wi, Li, L_inf) float32 [3] each: the unit direction to the distant
    light, its radiance, and the infinite light's radiance. Computed on the
    host, so the plain step and the CUDA kernel use the same bits."""
    wi = _f32(params.distant_inv_direction, "cpu")
    wi = wi / torch.linalg.vector_norm(wi)
    Li = _f32(params.distant_xyz, "cpu") * params.distant_multiplier
    L_inf = _f32(params.infinite_xyz, "cpu") * params.infinite_multiplier
    return wi.to(device), Li.to(device), L_inf.to(device)


def make_step(medium: Medium, params: IntegratorParams, bb_table: Optional[torch.Tensor],
              collect_debug: bool = False):
    """Build the single-iteration step: step(state, uniforms [N, 4]) -> state.

    collect_debug=True makes step return (state, dbg), where dbg is a dict of
    per-lane tensors saying what happened this iteration (collision flags,
    density, event kind, DDA cell, segment bounds), under the JAX step's
    keys: the channel behind the single-ray tools (tools/trace.py), which so
    instrument the real step and not a second implementation. The default
    path builds no dictionary. The CUDA kernel has no such channel: the tools
    run this plain step on one ray."""
    dgrid = medium.density
    dev = dgrid.device
    O = _f32(dgrid.origin_ijk, dev)
    bbox_lo = O
    bbox_hi = O + _f32(dgrid.shape, dev)

    sigma_a, sigma_s = params.sigma_a, params.sigma_s
    sigma_t = params.sigma_t
    g = params.hg_g
    emission_on = emission_enabled(medium, params)
    nee_on = params.nee_enabled
    wi, Li, L_inf = light_constants(params, dev)
    traverse = make_traversal(medium, params)
    bb_pairs = (
        blackbody_pairs(torch.as_tensor(bb_table, dtype=torch.float32, device=dev))
        if emission_on else None
    )

    def step(st: RayState, u: torch.Tensor) -> RayState:
        active = st.mode != DONE
        in_cam = st.mode == CAM
        in_shw = st.mode == SHADOW

        tr = traverse(st.o, st.d, st.t, st.t_exit, st.sig_seg, st.t_seg, active, u[:, 0])
        exited, fetch = tr.exited, tr.fetch
        t_cand, t_next, p_col = tr.t_cand, tr.t_next, tr.p_col
        rho, rsig, sigma_maj = tr.rho, tr.rsig, tr.sigma_maj
        real_col, zero_col = tr.real_col, tr.zero_col

        # ---- camera-mode collisions ----
        cam_col = in_cam & real_col
        p_a = sigma_a * rho * rsig
        p_s = sigma_s * rho * rsig
        p_n = torch.clamp(1.0 - p_a - p_s, min=0.0)

        L_new = st.L
        if emission_on:
            if tr.temp_adim is not None:
                temp_k = tr.temp_adim * params.temperature_scale + params.temperature_offset
            else:
                temp_k = sample_temperature_kelvin(medium, params, p_col)
            emit = p_a[:, None] * params.le_scale * blackbody_radiation_xyz_from_pairs(bb_pairs, temp_k)
            L_new = L_new + torch.where(cam_col[:, None], emit * st.wscore[:, None], 0.0)

        event = vrng.sample_discrete3(p_n, p_a, p_s, u[:, 1])
        cam_null = cam_col & (event == 0)
        cam_abs = cam_col & (event == 1)
        cam_scat = cam_col & (event == 2)
        # Score factor of the event choice: 1.0 in value, d log p_e in gradient.
        p_e = torch.where(event == 0, p_n, torch.where(event == 1, p_a, p_s))
        p_e_safe = torch.clamp(p_e, min=_TINY)
        ratio_e = p_e_safe / p_e_safe.detach()
        wscore_new = torch.where(cam_col, st.wscore * ratio_e, st.wscore)

        new_dir = sample_henyey_greenstein(st.d, u[:, 2], u[:, 3], g)
        phase_new = henyey_greenstein((st.d * wi).sum(dim=-1), g)
        depth_new = torch.where(cam_scat, st.depth + 2, st.depth)
        pend_o_new = torch.where(cam_scat[:, None], p_col, st.pend_o)
        pend_d_new = torch.where(cam_scat[:, None], new_dir, st.pend_d)
        phase_val_new = torch.where(cam_scat, phase_new, st.phase_val)

        # ---- shadow-mode collisions (ratio tracking + Russian roulette) ----
        shw_col = in_shw & real_col
        sigma_n = torch.clamp(sigma_maj - sigma_t * rho, min=0.0)
        T_after = st.T_ray * (sigma_n * rsig)
        rr = T_after <= 0.05
        # u1 is shared: camera lanes draw the event, shadow lanes the roulette.
        rr_kill = rr & (u[:, 1] < 0.75)
        T_after = torch.where(rr_kill, 0.0, torch.where(rr, T_after / 0.25, T_after))
        T_ray_new = torch.where(shw_col, T_after, st.T_ray)
        shw_dead = shw_col & (T_ray_new <= 0.0)
        shadow_finish = (in_shw & exited) | shw_dead
        contrib = st.phase_val[:, None] * T_ray_new[:, None] * Li * wscore_new[:, None]
        L_new = L_new + torch.where(shadow_finish[:, None], contrib, 0.0)

        # ---- resume / retire ----
        if nee_on:
            start_shadow = cam_scat
            resume = shadow_finish
        else:
            start_shadow = torch.zeros_like(cam_scat)
            resume = shadow_finish | cam_scat

        new_o = torch.where(start_shadow[:, None], p_col, pend_o_new)
        new_d = torch.where(start_shadow[:, None], wi, pend_d_new)
        t0n, t1n, hitn = clip_ray(new_o, new_d, bbox_lo, bbox_hi)

        depth_ok = depth_new < params.max_depth
        resume_ok = resume & hitn & depth_ok
        resume_escape = resume & ((~hitn) | (~depth_ok))

        start_shadow_ok = start_shadow & hitn
        # A shadow ray that misses the bbox keeps T = 1 (worker.cpp:63).
        shadow_miss = start_shadow & (~hitn)
        L_new = L_new + torch.where(
            shadow_miss[:, None], phase_val_new[:, None] * Li * wscore_new[:, None], 0.0
        )
        t0p, t1p, hitp = clip_ray(pend_o_new, pend_d_new, bbox_lo, bbox_hi)
        miss_resume_ok = shadow_miss & hitp & depth_ok
        miss_resume_escape = shadow_miss & ((~hitp) | (~depth_ok))

        becomes_done_inf = (in_cam & exited) | resume_escape | miss_resume_escape
        L_new = L_new + torch.where(becomes_done_inf[:, None], L_inf * wscore_new[:, None], 0.0)

        mode_new = torch.where(becomes_done_inf | cam_abs, DONE, st.mode)
        mode_new = torch.where(start_shadow_ok, SHADOW, mode_new)
        mode_new = torch.where(resume_ok | miss_resume_ok, CAM, mode_new).to(torch.int32)

        o_new = torch.where(start_shadow_ok[:, None], new_o, st.o)
        d_new = torch.where(start_shadow_ok[:, None], new_d, st.d)
        t_new = torch.where(start_shadow_ok, t0n, st.t)
        t_exit_new = torch.where(start_shadow_ok, t1n, st.t_exit)

        o_new = torch.where(resume_ok[:, None], pend_o_new, o_new)
        d_new = torch.where(resume_ok[:, None], pend_d_new, d_new)
        fresh = resume & (~start_shadow)
        t_new = torch.where(resume_ok, torch.where(fresh, t0n, t0p), t_new)
        t_exit_new = torch.where(resume_ok, torch.where(fresh, t1n, t1p), t_exit_new)
        o_new = torch.where(miss_resume_ok[:, None], pend_o_new, o_new)
        d_new = torch.where(miss_resume_ok[:, None], pend_d_new, d_new)
        t_new = torch.where(miss_resume_ok, t0p, t_new)
        t_exit_new = torch.where(miss_resume_ok, t1p, t_exit_new)

        plain_adv = cam_null | zero_col | (in_shw & real_col & ~shadow_finish)
        t_new = torch.where(plain_adv, t_cand, t_new)
        t_new = torch.where(fetch, t_next, t_new)

        # fetch lanes install the fresh segment; lanes starting a new ray
        # invalidate it (t_seg = t: the next step fetches).
        new_ray = start_shadow_ok | resume_ok | miss_resume_ok
        sig_seg_new = torch.where(fetch, tr.sig_seg_f, st.sig_seg)
        sig_seg_new = torch.where(new_ray, 0.0, sig_seg_new)
        t_seg_new = torch.where(fetch, tr.t_seg_f, st.t_seg)
        t_seg_new = torch.where(new_ray, t_new, t_seg_new)

        st_new = RayState(
            o=o_new, d=d_new, t=t_new, t_exit=t_exit_new,
            sig_seg=sig_seg_new, t_seg=t_seg_new, L=L_new, wscore=wscore_new,
            depth=depth_new, mode=mode_new, terminated=st.terminated | cam_abs,
            pend_o=pend_o_new, pend_d=pend_d_new,
            T_ray=torch.where(start_shadow_ok, 1.0, T_ray_new),
            phase_val=phase_val_new, ctr=st.ctr + 1,
        )
        if not collect_debug:
            return st_new
        dbg = dict(
            active=active, in_cam=in_cam, in_shw=in_shw,
            cell_lo=tr.cell_lo, cell_sz=tr.cell_sz, use_super=tr.use_super,
            maj=sigma_maj / sigma_t if sigma_t else sigma_maj,
            sigma_maj=sigma_maj,
            t0=st.t, t_seg_end=torch.where(fetch, tr.t_seg_f, st.t_seg),
            t_cand=t_cand, fetch=fetch,
            collide=tr.collide, exited=exited, stepped=fetch,
            p_col=p_col, rho=rho, zero_col=zero_col,
            cam_null=cam_null, cam_abs=cam_abs, cam_scat=cam_scat,
            p_a=p_a, p_s=p_s, p_n=p_n,
            shw_col=shw_col, T_ray=T_ray_new, shadow_finish=shadow_finish,
            start_shadow=start_shadow_ok, resume=resume_ok,
            new_dir=new_dir, becomes_done_inf=becomes_done_inf,
        )
        return st_new, dbg

    return step


def init_state(medium: Medium, o_world: torch.Tensor, d_world: torch.Tensor, params: IntegratorParams) -> RayState:
    """World rays -> initial state. Rays that miss the index bbox retire at
    once (DONE, not terminated) and collect the infinite light here."""
    dgrid = medium.density
    N = o_world.shape[0]
    dev = o_world.device
    O = _f32(dgrid.origin_ijk, dev)
    o_idx = dgrid.world_to_index(o_world)
    d_idx = d_world  # unit under uniform scale
    t0, t1, hit = clip_ray(o_idx, d_idx, O, O + _f32(dgrid.shape, dev))
    zeros = torch.zeros((N,), dtype=torch.float32, device=dev)
    t_init = torch.where(hit, t0, 0.0)
    _, _, L_inf = light_constants(params, dev)
    L0 = torch.where(hit[:, None], 0.0, L_inf[None, :].expand(N, 3))
    return RayState(
        o=o_idx,
        d=d_idx,
        t=t_init,
        t_exit=torch.where(hit, t1, 0.0),
        sig_seg=zeros,
        t_seg=t_init,
        L=L0,
        wscore=torch.ones((N,), dtype=torch.float32, device=dev),
        depth=torch.zeros((N,), dtype=torch.int32, device=dev),
        mode=torch.where(hit, CAM, DONE).to(torch.int32),
        terminated=torch.zeros((N,), dtype=torch.bool, device=dev),
        pend_o=o_idx,
        pend_d=d_idx,
        T_ray=torch.ones((N,), dtype=torch.float32, device=dev),
        phase_val=zeros,
        ctr=torch.zeros((N,), dtype=torch.int32, device=dev),
    )


def finalize_radiance(st: RayState, params: IntegratorParams) -> torch.Tensor:
    """Per-ray XYZ radiance [N, 3]. Lanes still alive at the iteration cap
    are truncated: they keep what they gathered and collect no infinite
    light (callers surface the count as n_capped)."""
    del params
    return st.L


def count_capped(st: RayState) -> torch.Tensor:
    """Number of lanes still alive (mid-volume): the iteration-cap counter."""
    return (st.mode != DONE).sum()


def lane_iterations(st: RayState) -> torch.Tensor:
    """The lane-iterations of a loop that ended in `st` (0-d int64): over the
    loop's steps, the lanes alive after each, summed, as the JAX package's
    trace_rays counts them. A lane is alive after each of its `ctr` steps
    but a last one that retired it (DONE), so this is the sum of the
    counters less the lanes that stepped and are DONE. A pure work count:
    every lane's path is fixed by its counter-keyed draws, so it does not
    depend on how lanes are split over launches, cells or processes."""
    stepped_done = (st.mode == DONE) & (st.ctr > 0)
    return st.ctr.to(torch.int64).sum() - stepped_done.sum()


def alive_first_perm(done: torch.Tensor) -> torch.Tensor:
    """Stable alive-first permutation: indices of the alive lanes in order,
    then the done lanes in order."""
    n = done.shape[0]
    alive = ~done
    na = torch.cumsum(alive.to(torch.int64), 0)
    nd = torch.cumsum(done.to(torch.int64), 0)
    pos = torch.where(alive, na - 1, na[-1] + nd - 1)
    perm = torch.empty((n,), dtype=torch.int64, device=done.device)
    perm[pos] = torch.arange(n, dtype=torch.int64, device=done.device)
    return perm


def compact_lanes(keep: torch.Tensor, tree):
    """Gather lanes `keep` from every [N] / [N, C] tensor of a (nested)
    tuple / NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, keep)
    items = [compact_lanes(keep, x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def compaction_widths(N, min_width=512, num=1, den=2, max_stages=8, align=1):
    """Compaction ladder: stage widths from N down to min_width."""
    widths = []
    w = N
    while w > min_width and len(widths) < max_stages:
        w = max(min_width, -(-(w * num // den) // align) * align)
        widths.append(w)
    return widths


def lane_streams(stream, n: int, device) -> torch.Tensor:
    """Stream word(s) as a per-lane [n] int64 tensor of uint32 values."""
    return (torch.as_tensor(stream, device=device).to(torch.int64) & 0xFFFFFFFF).expand(n).contiguous()


def advance_lanes(
    step, st: RayState, pixel_ids: torch.Tensor, streams: torch.Tensor, max_steps: int,
    observe=None, extra: Tuple[torch.Tensor, ...] = (),
):
    """The plain tracer's loop: every lane of `st` steps until DONE or until
    it has taken `max_steps` steps in this call; returns the whole state.

    Lanes are compacted whenever the alive count fits the next narrower
    width. A DONE lane takes no step and keeps its counter, so the result is
    bitwise that of a full-width loop (and of the CUDA kernel's contract).

    observe(st, st_next, extra) -> extra, if given, sees every step from
    outside (the gradient path's record pass); `extra` is a tuple of per-lane
    [N, ...] tensors compacted with the lanes, and the call then returns
    (state, extra).
    """
    N = st.mode.shape[0]
    full, full_extra = st, extra
    idx_map = torch.arange(N, dtype=torch.int64, device=st.mode.device)
    pids = pixel_ids.to(torch.int64) & 0xFFFFFFFF
    streams = streams.to(torch.int64) & 0xFFFFFFFF
    it = 0
    for next_w in compaction_widths(N) + [None]:
        alive = int(count_capped(st))
        while it < max_steps and alive > 0 and (next_w is None or alive > next_w):
            active = st.mode != DONE
            nxt = step(st, vrng.counter_uniforms(pids, streams, st.ctr, 4))
            nxt = nxt._replace(ctr=torch.where(active, nxt.ctr, st.ctr))
            if observe is not None:
                extra = observe(st, nxt, extra)
            st = nxt
            it += 1
            alive = int(count_capped(st))
        full = RayState(*(f.index_copy(0, idx_map, s) for f, s in zip(full, st)))
        full_extra = tuple(f.index_copy(0, idx_map, s) for f, s in zip(full_extra, extra))
        # Stop before compacting once the cap is hit (or nothing is alive):
        # n_capped then counts every alive lane. (The JAX trace_rays
        # compacts first and so undercounts when the cap hits a stage with
        # more alive lanes than the next width.)
        if next_w is None or it >= max_steps or alive == 0:
            break
        keep = alive_first_perm(st.mode == DONE)[:next_w]
        st, idx_map, pids, streams, extra = compact_lanes(keep, (st, idx_map, pids, streams, extra))
    return (full, full_extra) if observe is not None else full


def trace_rays(
    medium: Medium,
    params: IntegratorParams,
    bb_table: Optional[torch.Tensor],
    o_world: torch.Tensor,
    d_world: torch.Tensor,
    pixel_ids: torch.Tensor,
    stream,
    return_lane_iters: bool = False,
):
    """Forward render of a ray batch: the plain step in a loop
    (advance_lanes), up to params.max_iters steps.

    Returns (radiance [N, 3], iterations, n_capped), the last two as 0-d
    tensors (iterations = the largest lane counter); return_lane_iters=True
    appends the loop's lane-iterations (lane_iterations).
    """
    st = init_state(medium, o_world, d_world, params)
    N = pixel_ids.shape[0]
    dev = o_world.device
    st = advance_lanes(make_step(medium, params, bb_table), st, pixel_ids,
                       lane_streams(stream, N, dev), params.max_iters)
    iters = st.ctr.max().to(torch.int64) if N else torch.zeros((), dtype=torch.int64, device=dev)
    if return_lane_iters:
        return finalize_radiance(st, params), iters, count_capped(st), lane_iterations(st)
    return finalize_radiance(st, params), iters, count_capped(st)


def trace_rays_diff(
    medium: Medium,
    params: IntegratorParams,
    bb_table: Optional[torch.Tensor],
    o_world: torch.Tensor,
    d_world: torch.Tensor,
    pixel_ids: torch.Tensor,
    stream,
    n_iters: int,
) -> torch.Tensor:
    """Differentiable forward render: `n_iters` steps of make_step on every
    lane under torch autograd; returns radiance [N, 3].

    The bounded loop caps path length (lanes alive at the cap are truncated
    as in trace_rays); each step runs under torch.utils.checkpoint
    (non-reentrant), so the backward pass keeps one state per step and
    recomputes the step's inside, as jax.checkpoint does. A DONE lane's step
    changes nothing, so the value equals trace_rays at max_iters = n_iters.
    Gradients reach medium.density.data and medium.temperature.data when
    they require them; majorants and tables are detached. The oracle of the
    replay gradient: CPU and tests, never a card's main path.
    """
    from torch.utils.checkpoint import checkpoint

    step = make_step(medium, params, bb_table)
    st = init_state(medium, o_world, d_world, params)
    streams = lane_streams(stream, pixel_ids.shape[0], o_world.device)
    pids = pixel_ids.to(torch.int64) & 0xFFFFFFFF

    def body(st_):
        return step(st_, vrng.counter_uniforms(pids, streams, st_.ctr, 4))

    grad = torch.is_grad_enabled()
    for _ in range(n_iters):
        st = checkpoint(body, st, use_reentrant=False) if grad else body(st)
    return finalize_radiance(st, params)
