"""Debug tracing: majorant/DDA segment dumps and path-event logs.

Port of volume_path_tracer_tpu/tools/trace.py; tooling parity with the
reference renderer's verification instrumentation:
  - majorant_trace: CSV "X0..Z1,T0,T1,Majorant" per segment along one ray,
    the columns of Volume::log_majorant_trace (volume.cpp:176-192), consumed
    by scripts/plot_majorant_trace.py to show majorant >= density.
  - dda_trace: CSV "X,Y,Z,T,Value,Dim,Active,Maximum" per voxel step, the
    analog of Volume::log_dda_trace (volume.cpp:194-225; the Dim column is
    the traversal cell size 8/64 instead of the VDB getDim).
  - trace_path_events: the Logger-equivalent event stream (new_ray /
    sampled_point / null / scatter / absorbed / shadow_*, worker.cpp:15-49),
    produced by stepping the REAL integrator step function one iteration at
    a time with its debug channel, not a second implementation.

All functions are host-side debug paths on one ray: the walks are numpy over
the medium's arrays, brought to the host once, and the event stream runs the
plain step (render/integrator.py) on the medium's device. The CUDA kernel
takes no part.
"""
from __future__ import annotations

import csv
from typing import List

import numpy as np
import torch

from ..grids.majorant import BRICK, SUPER
from ..models.medium import Medium
from ..render.integrator import DONE, IntegratorParams, init_state, make_step
from ..utils import rng as vrng


def _ray_to_index(medium: Medium, o_world, d_world):
    g = medium.density
    o = g.world_to_index(torch.as_tensor(np.asarray(o_world), dtype=torch.float32)).numpy()
    d = np.asarray(d_world, np.float64)
    d = d / np.linalg.norm(d)
    return o, d


def _clip_np(o, d, lo, hi, t_min=1e-4):
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12 * np.where(d < 0, -1, 1), d)
    ta, tb = (lo - o) * inv, (hi - o) * inv
    t0 = max(np.minimum(ta, tb).max(), t_min)
    t1 = np.maximum(ta, tb).min()
    return t0, t1, t0 < t1


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def majorant_segments(medium: Medium, o_world, d_world, sigma_t: float = 1.0):
    """Walk one ray's brick/superbrick segments; returns list of
    (t0, t1, majorant_density) in voxel units (density-grid index space)."""
    g = medium.density
    o, d = _ray_to_index(medium, o_world, d_world)
    O = np.asarray(g.origin_ijk, np.float64)
    hi = O + np.asarray(g.shape, np.float64)
    t0, t1, hit = _clip_np(o, d, O, hi)
    if not hit:
        return []
    brick = _host(medium.majorants.brick_maj)
    sup = _host(medium.majorants.super_maj)
    segs = []
    t = t0
    eps = 1e-3
    while t < t1 - 1e-6 and len(segs) < 100000:
        p = o + d * (t + eps)
        lp = p - O
        bb = np.floor(lp / BRICK).astype(int)
        sb = np.floor(lp / (BRICK * SUPER)).astype(int)
        in_b = (bb >= 0).all() and (bb < brick.shape).all()
        bmaj = brick[tuple(bb)] if in_b else 0.0
        smaj = sup[tuple(sb)] if (sb >= 0).all() and (sb < sup.shape).all() else 0.0
        use_super = smaj <= 0.0
        size = BRICK * SUPER if use_super else BRICK
        cell = sb if use_super else bb
        lo_c = cell * size + O
        _, t_exit, _ = _clip_np(o, d, lo_c, lo_c + size, t_min=-1e30)
        t_end = min(t_exit, t1)
        t_end = max(t_end, t + 2 * eps)
        segs.append((t, t_end, 0.0 if use_super else float(bmaj)))
        t = t_end
    # merge consecutive equal-majorant segments (volume.cpp:53-71 semantics)
    merged = []
    for s in segs:
        if merged and abs(merged[-1][2] - s[2]) < 1e-12 and abs(merged[-1][1] - s[0]) < 1e-5:
            merged[-1] = (merged[-1][0], s[1], s[2])
        else:
            merged.append(list(s))
    return [tuple(m) for m in merged]


def majorant_trace(medium: Medium, o_world, d_world, path: str = "majorant_trace.csv"):
    """Write the reference-format majorant trace CSV (volume.cpp:180)."""
    g = medium.density
    o, d = _ray_to_index(medium, o_world, d_world)
    segs = majorant_segments(medium, o_world, d_world)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["X0", "Y0", "Z0", "X1", "Y1", "Z1", "T0", "T1", "Majorant"])
        for t0, t1, maj in segs:
            p0 = o + d * t0
            p1 = o + d * t1
            w.writerow([*p0, *p1, t0 * g.voxel_size, t1 * g.voxel_size, maj])
    return segs


def dda_trace(medium: Medium, o_world, d_world, path: str = "dda_trace.csv"):
    """Voxel-level DDA dump (log_dda_trace analog, volume.cpp:194-225)."""
    g = medium.density
    o, d = _ray_to_index(medium, o_world, d_world)
    O = np.asarray(g.origin_ijk, np.float64)
    hi = O + np.asarray(g.shape, np.float64)
    t0, t1, hit = _clip_np(o, d, O, hi)
    rows = []
    if hit:
        brick = _host(medium.majorants.brick_maj)
        sup = _host(medium.majorants.super_maj)
        data = _host(g.data)
        t = t0
        while t < t1 and len(rows) < 100000:
            p = o + d * (t + 1e-3)
            ijk = np.floor(p).astype(int)
            lp = ijk - O.astype(int)
            in_range = (lp >= 0).all() and (lp < data.shape).all()
            val = float(data[tuple(lp)]) if in_range else 0.0
            bb = (lp // BRICK).astype(int)
            bmaj = float(brick[tuple(bb)]) if in_range else 0.0
            sb = (lp // (BRICK * SUPER)).astype(int)
            smaj = float(sup[tuple(sb)]) if in_range else 0.0
            dim = BRICK * SUPER if smaj <= 0 else BRICK
            rows.append([*ijk, t, val, dim, int(val > 0), bmaj])
            # advance one voxel boundary
            lo_v = ijk.astype(np.float64)
            _, t_exit, _ = _clip_np(o, d, lo_v, lo_v + 1.0, t_min=-1e30)
            t = max(t_exit, t + 1e-3)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["X", "Y", "Z", "T", "Value", "Dim", "Active", "Maximum"])
        w.writerows(rows)
    return rows


def trace_path_events(
    medium: Medium,
    params: IntegratorParams,
    bb_table,
    o_world,
    d_world,
    pixel_id: int = 0,
    seed: int = 0,
    wave: int = 1,
    max_iters: int = 4096,
) -> List[dict]:
    """Step the real integrator for ONE ray, emitting Logger-style events.

    Event kinds: new_ray, sampled_point, null, scatter, absorbed,
    shadow_start, shadow_point, shadow_done, escaped: a superset of the
    reference Logger's stream (worker.cpp:15-49) with the NEE sub-path made
    explicit.
    """
    dev = medium.device
    step = make_step(medium, params, bb_table, collect_debug=True)
    o = torch.as_tensor(np.asarray([o_world]), dtype=torch.float32).to(dev)
    d = torch.as_tensor(np.asarray([d_world]), dtype=torch.float32).to(dev)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    st = init_state(medium, o, d, params)
    pids = torch.tensor([pixel_id], dtype=torch.int32, device=dev)
    stream = vrng.mix_stream(seed, wave)
    g = medium.density

    def w(p_idx):
        return g.index_to_world(torch.as_tensor(p_idx)).numpy()

    events: List[dict] = [dict(kind="new_ray", origin=_host(o[0]), direction=_host(d[0]))]
    for it in range(max_iters):
        if int(st.mode[0]) == DONE:
            break
        # Same draw budget as the production loop (4 draws an iteration on
        # the lane's counter): the trace consumes the EXACT uniform stream
        # the render consumes.
        u = vrng.counter_uniforms(pids, stream, it, 4)
        st, dbg = step(st, u)
        b = {k: _host(v[0]) for k, v in dbg.items()}
        if b["collide"] and b["rho"] > 0:
            kind = "sampled_point" if b["in_cam"] else "shadow_point"
            events.append(dict(kind=kind, point=w(b["p_col"]), density=float(b["rho"]),
                               sigma_maj=float(b["sigma_maj"]), t=float(b["t_cand"])))
        if b["cam_null"]:
            events.append(dict(kind="null"))
        if b["cam_abs"]:
            events.append(dict(kind="absorbed"))
        if b["cam_scat"]:
            events.append(dict(kind="scatter", point=w(b["p_col"]),
                               new_direction=b["new_dir"]))
        if b["start_shadow"]:
            events.append(dict(kind="shadow_start", point=w(b["p_col"])))
        if b["shadow_finish"]:
            events.append(dict(kind="shadow_done", T_ray=float(b["T_ray"])))
        if b["becomes_done_inf"] and b["in_cam"]:
            events.append(dict(kind="escaped"))
    events.append(dict(kind="radiance", L=_host(st.L[0]), terminated=bool(st.terminated[0])))
    return events


def write_path_events_csv(events: List[dict], path: str = "log.csv") -> None:
    """Serialize events in the reference Logger's CSV shape (worker.cpp:15-49):
    kind, then positional floats (origin/dir, point, density, ...)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for e in events:
            row = [e["kind"]]
            for key in ("origin", "direction", "point", "new_direction"):
                if key in e:
                    row.extend(float(x) for x in np.ravel(e[key]))
            for key in ("density", "sigma_maj", "t", "T_ray"):
                if key in e:
                    row.append(float(e[key]))
            if "L" in e:
                row.extend(float(x) for x in e["L"])
            w.writerow(row)
