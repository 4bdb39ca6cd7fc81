"""Path-replay backpropagation (PRB): the gradient of a forward render.

Port of volume_path_tracer_tpu/diff/prb.py. Every draw is a pure function of
(pixel id, stream, per-lane counter) (utils/rng.py), so a lane's whole path
can be walked again. The backward pass is a second lane loop:

  - forward: the production tracer, recording one float per NEE shadow walk
    (_trace_rays_record): T_final > 0 for a walk that left the volume,
    -(counter after the walk) < 0 for a walk killed by roulette or by
    sigma_n = 0, and 0 for a walk the iteration cap cut;
  - backward (replay_grads): replay each lane with the same draws, keeping
    the scalar suffix <g, L_total - L_accumulated>, and at each event add the
    analytic derivative into corner-row gradient tables:
      * emission: d(p_a * le * bb(T)) w.r.t. the 8 density corners (through
        p_a = sigma_a * rho / sigma_maj) and the 8 temperature corners
        (through the blackbody LUT's slope);
      * the discrete event choice: the score factor d p_e / p_e times the
        suffix radiance at and after the event;
      * NEE ratio tracking: each shadow collision's factor sigma_n /
        sigma_maj, whose gradient per corner is -phase * <g, Li> * sigma_t *
        T_final / sigma_n. A recorded walk is walked once (GRAD); a walk
        beyond the K recorded slots, or every walk when nothing was
        recorded, is walked twice: PRE reproduces the forward to learn
        T_final, GRAD walks it again from the same counter and scatters.

Majorants and event selections stay detached, as in the autograd oracle
(integrator.trace_rays_diff), so the replay's gradient equals torch autograd
of that loop to float precision. A forward lane draws counters 0 ..
max_iters - 1; the replay retires a lane whose counter reaches max_iters
(truncation parity). Gradients go to the density and temperature data only.

The functions here are the plain versions. On the card trace_rays_prb's
forward runs the record instantiation of the lane kernel and its backward
the replay kernel (render/megakernel.py record_lanes / replay_lanes): both
make each lane's initial state from its ray themselves, the record hands
the replay each lane's last counter, and the replay takes its lanes longest
first and adds each event's 8 weighted corners with float atomics straight
into the [X, Y, Z] gradient grids, with no corner-row table to fold (the
tables and fold_corner_rows stay on the plain path, held to the JAX
package); the JAX package's two-level compacted scatter
(compact_scatter_fitting) exists to send fewer rows to the TPU's scatter
engine and computes direct_scatter's sum, which index_add_ and atomics
compute directly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..grids.grid import corner_row_index, trilinear_weights
from ..models.medium import Medium
from ..ops.phase import henyey_greenstein, sample_henyey_greenstein
from ..render.integrator import (
    CAM,
    SHADOW,
    IntegratorParams,
    _TINY,
    _f32,
    advance_lanes,
    alive_first_perm,
    clip_ray,
    compact_lanes,
    compaction_widths,
    emission_enabled,
    finalize_radiance,
    init_state,
    lane_streams,
    light_constants,
    make_step,
    make_traversal,
    sample_temperature_kelvin,
)
from ..utils import rng as vrng
from ..utils.spans import span
from ..utils.spectral import blackbody_radiation_xyz_value_grad

# Replay lane modes.
RCAM = 0  # camera delta tracking (the forward's CAM events)
RPRE = 1  # shadow ray, first walk: reproduce the forward, learn T_final
RGRAD = 2  # shadow ray, gradient walk: scatter the ratio-tracking gradients
RDONE = 3

_CORNER_OFFSETS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]

# Saved-walk residual slots per lane; a walk past slot K replays PRE+GRAD,
# so K trades residual memory against PRE work only.
DEFAULT_K_WALKS = 16

# Replay counters are exact as float32 residuals only below 2^24.
MAX_RECORD_ITERS = 2**24


class ReplayState(NamedTuple):
    """SoA replay state; [N], [N, 3] or [N, K] per field."""

    o: torch.Tensor
    d: torch.Tensor
    t: torch.Tensor
    t_exit: torch.Tensor
    sig_seg: torch.Tensor
    t_seg: torch.Tensor
    gL_acc: torch.Tensor  # <g, L accumulated so far>
    depth: torch.Tensor
    mode: torch.Tensor
    pend_o: torch.Tensor
    pend_d: torch.Tensor
    T_ray: torch.Tensor  # transmittance of the current shadow walk
    T_fin: torch.Tensor  # the walk's final transmittance (for the GRAD walk)
    phase_val: torch.Tensor
    sh_ctr0: torch.Tensor  # draw counter at the shadow start (PRE -> GRAD reset)
    sh_t0: torch.Tensor  # shadow ray clip entry
    sh_t1: torch.Tensor  # shadow ray clip exit
    ctr: torch.Tensor  # per-lane draw counter (replays the forward's counters)
    tf_row: torch.Tensor  # [N, K] recorded walk residuals ([N, 0]: none)
    wc: torch.Tensor  # int32 shadow walks started (the residual slot)


def dot3(a: torch.Tensor, b) -> torch.Tensor:
    """sum(a * b) over a last axis of 3, added left to right (the kernel's order)."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def fold_corner_rows(rows: torch.Tensor, shape) -> torch.Tensor:
    """Fold a corner-row gradient table [(X+1)(Y+1)(Z+1), 8] into the
    [X, Y, Z] grid.

    Row r is base coord b (-1..dim-1 per axis, grids/grid.corner_row_index);
    column c holds the contribution to voxel b + _CORNER_OFFSETS[c]. Voxel v
    sums table[(v - off_c) + 1, c] over the 8 corners: 8 shifted slices.
    Out-of-grid corner positions are never read, which is the per-corner
    validity of a flat scatter.
    """
    X, Y, Z = shape
    t4 = rows.reshape(X + 1, Y + 1, Z + 1, 8)
    out = None
    for c, (dx, dy, dz) in enumerate(_CORNER_OFFSETS):
        sl = t4[1 - dx:1 - dx + X, 1 - dy:1 - dy + Y, 1 - dz:1 - dz + Z, c]
        out = sl if out is None else out + sl
    return out


def direct_scatter(table: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """table[rows[k]] += vals[k] for every k with nz[k], in place; returns table."""
    return table.index_add_(0, rows[nz], vals[nz])


def _make_replay_step(medium: Medium, params: IntegratorParams, bb_table, k_walks: int = 0):
    """One replay iteration: step(st, u, gL_tot, g_vec) -> (st_new,
    density_payload, temperature_payload or None), each payload a (rows,
    vals [N, 8], nz) triple in corner-row layout for the caller to scatter.

    k_walks > 0: st.tf_row[:, :k_walks] holds _trace_rays_record's residuals
    and a shadow start goes straight to the GRAD walk (or skips a walk that
    contributed nothing by jumping the counter); walks past slot k_walks
    take the PRE+GRAD fallback.
    """
    use_saved = k_walks > 0
    dgrid = medium.density
    dev = dgrid.device
    O = _f32(dgrid.origin_ijk, dev)
    bbox_lo, bbox_hi = O, O + _f32(dgrid.shape, dev)
    sigma_a, sigma_s = params.sigma_a, params.sigma_s
    sigma_t = params.sigma_t
    hg_g = params.hg_g
    emission_on = emission_enabled(medium, params)
    nee_on = params.nee_enabled
    wi, Li, L_inf = light_constants(params, dev)
    traverse = make_traversal(medium, params)
    X, Y, Z = dgrid.shape
    bb = torch.as_tensor(bb_table, dtype=torch.float32, device=dev) if emission_on else None

    def step(st: ReplayState, u, gL_tot, g_vec):
        # Truncation parity: a forward lane stops drawing at max_iters.
        trunc = (st.mode != RDONE) & (st.ctr >= params.max_iters)
        mode0 = torch.where(trunc, RDONE, st.mode)
        active = mode0 != RDONE
        in_cam = mode0 == RCAM
        in_pre = mode0 == RPRE
        in_grad = mode0 == RGRAD
        gLi = dot3(g_vec, Li)
        gLinf = dot3(g_vec, L_inf)

        tr = traverse(st.o, st.d, st.t, st.t_exit, st.sig_seg, st.t_seg, active, u[:, 0])
        rho, rsig, sigma_maj, p_col = tr.rho, tr.rsig, tr.sigma_maj, tr.p_col
        real_col, zero_col = tr.real_col, tr.zero_col

        # ---- camera collision: emission, then the event ----
        cam_col = in_cam & real_col
        p_a = sigma_a * rho * rsig
        p_s = sigma_s * rho * rsig
        p_n = torch.clamp(1.0 - p_a - p_s, min=0.0)
        gL_acc = st.gL_acc
        demis = torch.zeros_like(rho)
        tw = tp_local = None
        if emission_on:
            temp_k, tp_local = sample_temperature_kelvin(medium, params, p_col, return_local=True)
            bb_val, bb_grad = blackbody_radiation_xyz_value_grad(bb, temp_k)
            gbb = dot3(g_vec, bb_val)
            gbbg = dot3(g_vec, bb_grad)
            gL_acc = gL_acc + torch.where(cam_col, p_a * params.le_scale * gbb, 0.0)
            # d emission / d rho_corner = (sigma_a / sigma_maj) * w * le * bb
            demis = torch.where(cam_col, (sigma_a * rsig) * params.le_scale * gbb, 0.0)
            # d emission / d T_corner = p_a * le * bb'(T) * temperature_scale * w
            tw = torch.where(cam_col, p_a * params.le_scale * gbbg * params.temperature_scale, 0.0)

        event = vrng.sample_discrete3(p_n, p_a, p_s, u[:, 1])
        is_null, is_abs = event == 0, event == 1
        cam_null = cam_col & is_null
        cam_abs = cam_col & is_abs
        cam_scat = cam_col & (event == 2)
        # Score factor: autograd of p_e_safe / detach(p_e_safe) gives
        # (d p_e / p_e_safe) * (the suffix radiance from this event on).
        dpn = torch.where(1.0 - p_a - p_s > 0.0, -(sigma_a + sigma_s), 0.0)
        coef = torch.where(is_null, dpn, torch.where(is_abs, sigma_a, sigma_s))
        p_e = torch.where(is_null, p_n, torch.where(is_abs, p_a, p_s))
        gsuffix = gL_tot - gL_acc  # this collision's emission is in acc already
        score_w = torch.where(cam_col & (p_e > _TINY),
                              (coef * rsig) / torch.clamp(p_e, min=_TINY) * gsuffix, 0.0)

        new_dir = sample_henyey_greenstein(st.d, u[:, 2], u[:, 3], hg_g)
        phase_new = henyey_greenstein((st.d * wi).sum(dim=-1), hg_g)
        depth_new = torch.where(cam_scat, st.depth + 2, st.depth)
        pend_o_new = torch.where(cam_scat[:, None], p_col, st.pend_o)
        pend_d_new = torch.where(cam_scat[:, None], new_dir, st.pend_d)
        phase_val_new = torch.where(cam_scat, phase_new, st.phase_val)

        # ---- shadow walks: PRE reproduces the forward, GRAD scatters ----
        shw_col_pre = in_pre & real_col
        shw_col_grad = in_grad & real_col
        shw_col = shw_col_pre | shw_col_grad
        sigma_n = torch.clamp(sigma_maj - sigma_t * rho, min=0.0)
        T_after = st.T_ray * (sigma_n * rsig)
        rr = T_after <= 0.05
        rr_kill = rr & (u[:, 1] < 0.75)
        T_after = torch.where(rr_kill, 0.0, torch.where(rr, T_after / 0.25, T_after))
        T_ray_new = torch.where(shw_col, T_after, st.T_ray)
        shw_dead = shw_col & (T_ray_new <= 0.0)
        pre_finish = (in_pre & tr.exited) | (shw_col_pre & shw_dead)
        grad_finish = (in_grad & tr.exited) | (shw_col_grad & shw_dead)
        # GRAD collision: d contribution / d rho_corner = -phase * <g, Li> *
        # sigma_t * (T_final / sigma_n) * w; 0 where sigma_n clamps to 0.
        shadow_w = torch.where(
            shw_col_grad & (sigma_n > 0.0),
            -st.phase_val * gLi * sigma_t * st.T_fin / torch.clamp(sigma_n, min=_TINY), 0.0)
        # PRE completion: the forward added the shadow contribution here.
        gL_acc = gL_acc + torch.where(pre_finish, st.phase_val * T_ray_new * gLi, 0.0)
        T_fin_new = torch.where(pre_finish, T_ray_new, st.T_fin)
        go_grad = pre_finish & (T_fin_new > 0.0)
        pre_resume = pre_finish & (~go_grad)  # contributed nothing: no GRAD walk

        # ---- resume / retire (integrator.make_step) ----
        shadow_done = grad_finish | pre_resume
        if nee_on:
            start_shadow = cam_scat
            resume = shadow_done
        else:
            start_shadow = torch.zeros_like(cam_scat)
            resume = shadow_done | cam_scat
        new_o = torch.where(start_shadow[:, None], p_col, pend_o_new)
        new_d = torch.where(start_shadow[:, None], wi, pend_d_new)
        t0n, t1n, hitn = clip_ray(new_o, new_d, bbox_lo, bbox_hi)
        depth_ok = depth_new < params.max_depth
        resume_ok = resume & hitn & depth_ok
        resume_escape = resume & ((~hitn) | (~depth_ok))
        start_shadow_ok = start_shadow & hitn
        shadow_miss = start_shadow & (~hitn)
        gL_acc = gL_acc + torch.where(shadow_miss, phase_val_new * gLi, 0.0)
        t0p, t1p, hitp = clip_ray(pend_o_new, pend_d_new, bbox_lo, bbox_hi)
        miss_resume_ok = shadow_miss & hitp & depth_ok
        miss_resume_escape = shadow_miss & ((~hitp) | (~depth_ok))

        # ---- a recorded walk: its residual instead of a PRE walk ----
        false_ = torch.zeros_like(cam_scat)
        sv_live = sv_unfinished = sv_skip_ok = sv_skip_escape = sv_killed = false_
        start_pre_ok = start_shadow_ok
        ce_val = st.ctr
        tf_val = None
        if use_saved:
            slot = st.wc
            slot_ok = slot < k_walks
            tf_val = st.tf_row.gather(1, torch.clamp(slot, max=k_walks - 1).to(torch.int64)[:, None])[:, 0]
            tf_val = torch.where(slot_ok, tf_val, 0.0)
            saved_lane = start_shadow_ok & slot_ok
            sv_unfinished = saved_lane & (tf_val == 0.0)
            sv_live = saved_lane & (tf_val > 0.0)
            sv_killed = saved_lane & (tf_val < 0.0)
            ce_val = (-tf_val).to(torch.int32)  # exact: counters < 2^24
            # The forward added the walk's contribution at its end; no camera
            # event comes before the GRAD walk ends, so adding it now keeps
            # every later suffix right.
            gL_acc = gL_acc + torch.where(sv_live, phase_val_new * tf_val * gLi, 0.0)
            start_pre_ok = start_shadow_ok & (~slot_ok)
            sv_skip_ok = sv_killed & hitp & depth_ok
            sv_skip_escape = sv_killed & ((~hitp) | (~depth_ok))
        wc_new = st.wc + start_shadow_ok.to(torch.int32)

        done_inf = (in_cam & tr.exited) | resume_escape | miss_resume_escape | sv_skip_escape
        gL_acc = gL_acc + torch.where(done_inf, gLinf, 0.0)
        done_term = cam_abs | sv_unfinished
        mode_new = torch.where(done_inf | done_term, RDONE, mode0)
        mode_new = torch.where(start_pre_ok, RPRE, mode_new)
        mode_new = torch.where(resume_ok | miss_resume_ok | sv_skip_ok, RCAM, mode_new)
        mode_new = torch.where(go_grad | sv_live, RGRAD, mode_new).to(torch.int32)

        # ---- the next walk's ray ----
        o_new = torch.where(start_shadow_ok[:, None], new_o, st.o)
        d_new = torch.where(start_shadow_ok[:, None], new_d, st.d)
        t_new = torch.where(start_shadow_ok, t0n, st.t)
        t_exit_new = torch.where(start_shadow_ok, t1n, st.t_exit)
        o_new = torch.where(resume_ok[:, None], pend_o_new, o_new)
        d_new = torch.where(resume_ok[:, None], pend_d_new, d_new)
        fresh = resume & (~start_shadow)
        t_new = torch.where(resume_ok, torch.where(fresh, t0n, t0p), t_new)
        t_exit_new = torch.where(resume_ok, torch.where(fresh, t1n, t1p), t_exit_new)
        pend_resume = miss_resume_ok | sv_skip_ok  # resume from the pending ray
        o_new = torch.where(pend_resume[:, None], pend_o_new, o_new)
        d_new = torch.where(pend_resume[:, None], pend_d_new, d_new)
        t_new = torch.where(pend_resume, t0p, t_new)
        t_exit_new = torch.where(pend_resume, t1p, t_exit_new)
        # PRE -> GRAD: the saved shadow ray again, from its first counter.
        o_new = torch.where(go_grad[:, None], pend_o_new, o_new)
        d_new = torch.where(go_grad[:, None], wi, d_new)
        t_new = torch.where(go_grad, st.sh_t0, t_new)
        t_exit_new = torch.where(go_grad, st.sh_t1, t_exit_new)
        plain_adv = cam_null | zero_col | (shw_col & ~(pre_finish | grad_finish))
        t_new = torch.where(plain_adv, tr.t_cand, t_new)
        t_new = torch.where(tr.fetch, tr.t_next, t_new)

        new_ray = start_shadow_ok | resume_ok | miss_resume_ok | go_grad | sv_skip_ok
        sig_seg_new = torch.where(tr.fetch, tr.sig_seg_f, st.sig_seg)
        sig_seg_new = torch.where(new_ray, 0.0, sig_seg_new)
        t_seg_new = torch.where(tr.fetch, tr.t_seg_f, st.t_seg)
        t_seg_new = torch.where(new_ray, t_new, t_seg_new)
        T_ray_out = torch.where(start_shadow_ok | go_grad, 1.0, T_ray_new)
        if use_saved:
            T_fin_new = torch.where(sv_live, tf_val, T_fin_new)
        sh_ctr0_new = torch.where(start_shadow_ok, st.ctr, st.sh_ctr0)
        sh_t0_new = torch.where(start_shadow_ok, t0n, st.sh_t0)
        sh_t1_new = torch.where(start_shadow_ok, t1n, st.sh_t1)
        ctr_new = torch.where(go_grad, st.sh_ctr0, st.ctr) + 1
        if use_saved:
            ctr_new = torch.where(sv_killed, ce_val, ctr_new)  # past the walk's draws

        # ---- gradient payloads, corner-row layout ----
        # Disjoint lane sets: emission + score on camera collisions, shadow_w
        # on GRAD collisions; added in this order, as the kernel adds them.
        lp = p_col - O
        i0 = torch.floor(lp).to(torch.int64)
        w8 = trilinear_weights(lp - i0.to(lp.dtype))
        row8, rvalid = corner_row_index((X, Y, Z), i0)
        dweight = demis + score_w + shadow_w
        dpay = (row8, w8 * dweight[:, None], rvalid & (dweight != 0.0))
        tpay = None
        if emission_on:
            i0t = torch.floor(tp_local).to(torch.int64)
            w8t = trilinear_weights(tp_local - i0t.to(tp_local.dtype))
            row8t, rvalidt = corner_row_index(medium.temperature.shape, i0t)
            tpay = (row8t, w8t * tw[:, None], rvalidt & (tw != 0.0))

        st_new = ReplayState(
            o=o_new, d=d_new, t=t_new, t_exit=t_exit_new, sig_seg=sig_seg_new, t_seg=t_seg_new,
            gL_acc=gL_acc, depth=depth_new, mode=mode_new, pend_o=pend_o_new, pend_d=pend_d_new,
            T_ray=T_ray_out, T_fin=T_fin_new, phase_val=phase_val_new, sh_ctr0=sh_ctr0_new,
            sh_t0=sh_t0_new, sh_t1=sh_t1_new, ctr=ctr_new.to(torch.int32), tf_row=st.tf_row, wc=wc_new,
        )
        return st_new, dpay, tpay

    return step


def _replay_init(medium: Medium, params: IntegratorParams, o_world, d_world, g_vec, tf=None) -> ReplayState:
    """The replay's initial state, from integrator.init_state: a ray that
    misses the box is RDONE with <g, L_inf> accumulated."""
    st = init_state(medium, o_world, d_world, params)
    hit = st.mode == CAM
    N = st.mode.shape[0]
    dev = st.t.device
    _, _, L_inf = light_constants(params, dev)
    zeros = torch.zeros((N,), dtype=torch.float32, device=dev)
    izeros = torch.zeros((N,), dtype=torch.int32, device=dev)
    return ReplayState(
        o=st.o, d=st.d, t=st.t, t_exit=st.t_exit, sig_seg=st.sig_seg, t_seg=st.t_seg,
        gL_acc=torch.where(hit, 0.0, dot3(g_vec, L_inf)), depth=st.depth,
        mode=torch.where(hit, RCAM, RDONE).to(torch.int32), pend_o=st.pend_o, pend_d=st.pend_d,
        T_ray=st.T_ray, T_fin=zeros, phase_val=zeros, sh_ctr0=izeros, sh_t0=zeros, sh_t1=zeros,
        ctr=st.ctr, tf_row=tf if tf is not None else torch.zeros((N, 0), dtype=torch.float32, device=dev),
        wc=izeros,
    )


def replay_iteration_cap(params: IntegratorParams) -> int:
    """Replay steps a lane may take: each forward counter is replayed at most
    twice (camera or PRE, then GRAD)."""
    return 2 * params.max_iters + 4


def replay_grads(
    medium: Medium, params: IntegratorParams, bb_table, o_world, d_world, pixel_ids, stream,
    L_fwd, g_vec, with_check: bool = False, tf=None,
):
    """The backward replay; returns (d_density [X, Y, Z], d_temperature or
    None), scattered with index_add_ (direct_scatter) into corner-row tables
    and folded (fold_corner_rows).

    L_fwd: the forward radiance [N, 3]; g_vec: its cotangent [N, 3]. tf: [N,
    K] residuals of _trace_rays_record, or None to replay every shadow walk
    twice (PRE+GRAD). with_check=True also returns (gL_acc, gL_tot) [N]: the
    replayed <g, L> and <g, L_fwd>, equal lane for lane when the bookkeeping
    is exact. Lanes are compacted as in the forward loop (the JAX ladder);
    the gradient tables stay whole.
    """
    k_walks = 0 if tf is None else tf.shape[1]
    step = _make_replay_step(medium, params, bb_table, k_walks=k_walks)
    st = _replay_init(medium, params, o_world, d_world, g_vec, tf=tf)
    gL_tot_full = dot3(g_vec, L_fwd)
    N = st.t.shape[0]
    dev = st.t.device
    pids = pixel_ids.to(torch.int64) & 0xFFFFFFFF
    streams = lane_streams(stream, N, dev)
    X, Y, Z = medium.density.shape
    gd = torch.zeros(((X + 1) * (Y + 1) * (Z + 1), 8), dtype=torch.float32, device=dev)
    gt = None
    if emission_enabled(medium, params):
        tX, tY, tZ = medium.temperature.shape
        gt = torch.zeros(((tX + 1) * (tY + 1) * (tZ + 1), 8), dtype=torch.float32, device=dev)
    iter_cap = replay_iteration_cap(params)
    gL_fin = torch.zeros((N,), dtype=torch.float32, device=dev)
    idx_map = torch.arange(N, dtype=torch.int64, device=dev)
    gL_tot, g = gL_tot_full, g_vec
    it = 0
    for next_w in compaction_widths(N) + [None]:
        alive = int((st.mode != RDONE).sum())
        while it < iter_cap and alive > 0 and (next_w is None or alive > next_w):
            u = vrng.counter_uniforms(pids, streams, st.ctr, 4)
            st, dpay, tpay = step(st, u, gL_tot, g)
            direct_scatter(gd, *dpay)
            if tpay is not None:
                direct_scatter(gt, *tpay)
            it += 1
            alive = int((st.mode != RDONE).sum())
        gL_fin[idx_map] = st.gL_acc
        if next_w is None or it >= iter_cap or alive == 0:
            break
        keep = alive_first_perm(st.mode == RDONE)[:next_w]
        st, pids, streams, gL_tot, g, idx_map = compact_lanes(keep, (st, pids, streams, gL_tot, g, idx_map))

    with span("prb.fold"):
        d_density = fold_corner_rows(gd, (X, Y, Z))
        d_temp = fold_corner_rows(gt, medium.temperature.shape) if gt is not None else None
    if with_check:
        return d_density, d_temp, gL_fin, gL_tot_full
    return d_density, d_temp


def _trace_rays_record(
    medium: Medium, params: IntegratorParams, bb_table, o_world, d_world, pixel_ids, stream,
    k_walks: int,
):
    """Forward render recording each lane's NEE walks: (L [N, 3], tf [N, K]).

    The same loop and step as integrator.trace_rays (so L is bitwise its
    radiance); the recording watches mode changes from outside the step.
    Slot w of lane i is the lane's w-th started shadow walk (a shadow start
    that hits the box; the replay counts the same events):
      tf[i, w] > 0   the walk left the volume with transmittance tf[i, w];
      tf[i, w] < 0   the walk died (roulette or sigma_n = 0): -(the counter
                     after its last step), where the replay resumes;
      tf[i, w] == 0  the walk never ended (the iteration cap).
    """
    st, tf = record_state(medium, params, bb_table, o_world, d_world, pixel_ids, stream, k_walks)
    return finalize_radiance(st, params), tf


def record_state(
    medium: Medium, params: IntegratorParams, bb_table, o_world, d_world, pixel_ids, stream,
    k_walks: int,
):
    """_trace_rays_record's loop: (the final RayState, tf [N, K]). The state
    carries each lane's last counter, which the record kernel hands the
    replay. Refuses max_iters >= 2^24 when there are walks to record."""
    if k_walks > 0 and params.max_iters >= MAX_RECORD_ITERS:
        raise ValueError(f"max_iters {params.max_iters} >= 2^24: counters would not be exact residuals")
    step = make_step(medium, params, bb_table)
    st0 = init_state(medium, o_world, d_world, params)
    N = pixel_ids.shape[0]
    dev = o_world.device
    slots = torch.arange(k_walks, dtype=torch.int32, device=dev)

    def observe(st, nxt, extra):
        tf, wc = extra
        started = (st.mode == CAM) & (nxt.mode == SHADOW)
        fin = (st.mode == SHADOW) & (nxt.mode != SHADOW)
        slot = wc - 1  # the walk in flight
        val = torch.where(nxt.T_ray > 0.0, nxt.T_ray, -nxt.ctr.to(torch.float32))
        hot = (slots[None, :] == slot[:, None]) & fin[:, None] & (slot < k_walks)[:, None]
        return torch.where(hot, val[:, None], tf), wc + started.to(torch.int32)

    extra = (torch.zeros((N, k_walks), dtype=torch.float32, device=dev),
             torch.zeros((N,), dtype=torch.int32, device=dev))
    st, (tf, _) = advance_lanes(step, st0, pixel_ids, lane_streams(stream, N, dev), params.max_iters,
                                observe, extra)
    return st, tf


def _detached_medium(medium: Medium) -> Medium:
    import dataclasses

    temp = medium.temperature
    return dataclasses.replace(
        medium,
        density=medium.density.detached(),
        temperature=temp.detached() if temp is not None else None,
    )


class _PathReplay(torch.autograd.Function):
    """Radiance [N, 3] of a ray batch; backward by path replay."""

    @staticmethod
    def forward(ctx, density_data, temp_data, medium, params, bb_table, o_world, d_world,
                pixel_ids, stream, k_walks, want_grad):
        from ..render.megakernel import record_lanes, trace_rays_fused

        need_grad = any(ctx.needs_input_grad[:2]) and want_grad
        tf = ctr = None
        if need_grad:
            # The record runs whenever a gradient is wanted, with k_walks = 0
            # too: its counters order the replay's queue. Without NEE there
            # is no walk to record.
            k = k_walks if params.nee_enabled else 0
            with span("prb.record"):
                L, tf, ctr = record_lanes(medium, params, bb_table, o_world, d_world, pixel_ids, stream, k)
            if k == 0:
                tf = None
        else:
            # The same sample bit for bit: the record kernel starts its lanes
            # as init_state does (record_lanes).
            with span("prb.record"):
                L, _, _ = trace_rays_fused(medium, params, bb_table, o_world, d_world, pixel_ids, stream)
        L = L.contiguous()
        ctx.medium, ctx.params, ctx.bb_table, ctx.stream = medium, params, bb_table, stream
        ctx.has_temp = temp_data is not None
        if need_grad:
            ctx.save_for_backward(L, tf, ctr, o_world, d_world, pixel_ids)
        return L

    @staticmethod
    def backward(ctx, g_vec):
        from ..render.megakernel import longest_first, replay_lanes

        L, tf, ctr, o_world, d_world, pixel_ids = ctx.saved_tensors
        # The kernel's queue takes the longest lanes first; the plain replay
        # steps every lane at once and takes no order.
        with span("prb.replay"):
            order = longest_first(ctr) if ctr.is_cuda else None
            d_density, d_temp = replay_lanes(ctx.medium, ctx.params, ctx.bb_table, o_world, d_world,
                                             pixel_ids, ctx.stream, L, g_vec.contiguous(), tf=tf, order=order)
        if not ctx.has_temp:
            d_temp = None
        elif d_temp is None:  # a temperature grid that emits nothing
            d_temp = torch.zeros_like(ctx.medium.temperature.data)
        return d_density, d_temp, None, None, None, None, None, None, None, None, None


def trace_rays_prb(
    medium: Medium, params: IntegratorParams, bb_table, o_world, d_world, pixel_ids, stream,
    k_walks: int = DEFAULT_K_WALKS,
) -> torch.Tensor:
    """Differentiable forward render with a path-replay backward; returns
    radiance [N, 3], differentiable w.r.t. medium.density.data and
    medium.temperature.data (other inputs get no gradient).

    The forward is the production tracer (on the card the record
    instantiation of the lane kernel), recording one float per NEE walk
    (k_walks slots a lane) when a gradient is wanted; the backward replays
    the paths from the draw counters (on the card the replay kernel).
    k_walks = 0 records nothing and replays every walk PRE+GRAD.
    """
    temp = medium.temperature
    temp_data = temp.data if temp is not None else None
    return _PathReplay.apply(medium.density.data, temp_data, _detached_medium(medium), params, bb_table,
                             o_world.detach(), d_world.detach(), pixel_ids, stream, k_walks,
                             torch.is_grad_enabled())
