"""Plain PyTorch reference of the volume path tracer, written from its
published description and imported by nothing of the program.

What it works out again from the raw grids it is given:
  - the majorant pyramid: per 8^3 brick the largest density over the brick
    and a one-voxel halo (the trilinear stencil), per 8^3 bricks the largest
    brick majorant, optionally bloated;
  - trilinear density (and temperature, through the temperature grid's own
    world transform) from the grids zero-padded by one voxel, which is what a
    row of eight corners holds;
  - the pinhole camera of the reference renderer (look-at frame, film plane
    at z = 1, raster (0, 0) at screen (1, 1)) with its half-pixel jitter;
  - PCG4D counter-based draws keyed on (pixel id, stream word, the lane's
    step counter, 0), the jitter on the counter 0x7fffffff;
  - the walk: free flight through brick or superbrick segments (a crossing
    takes the superbrick when its extra null collisions stay under
    super_tau), delta tracking of the camera path with blackbody emission at
    every real collision, a {null, absorb, scatter} event, Henyey-Greenstein
    scattering, and next-event estimation toward the distant light by ratio
    tracking with Russian roulette below 0.05 (q = 0.75).

`walk` runs any float dtype: float32 is the reference, bfloat16 the control
that must fail the comparison. With `record_walks` it also keeps each shadow
walk's final transmittance, and with `replay` it walks every lane again and
returns the gradient of <g, L> with respect to the density grid (the score
of each camera event and the ratio-tracking factors; majorants and event
choices held fixed), which is what path-replay backpropagation computes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .spectral import Blackbody

CAM, SHADOW, DONE = 0, 1, 2
JITTER_CTR = 0x7FFFFFFF
BRICK = 8
SUPER = 8
_M32 = 0xFFFFFFFF
_ONE_MINUS = float(np.float32(1.0 - 2.0 ** -24))


def _f32(x) -> float:
    return float(np.float32(x))


# ---------------------------------------------------------------- draws ----

def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def pcg4d(a, b, c, d):
    """PCG4D (Jarzynski and Olano 2020) on int64 tensors holding uint32 words."""
    v = [(x.to(torch.int64) & _M32) * 1664525 + 1013904223 & _M32 for x in (a, b, c, d)]
    for round_ in range(2):
        v[0] = (v[0] + _mul32(v[1], v[3])) & _M32
        v[1] = (v[1] + _mul32(v[2], v[0])) & _M32
        v[2] = (v[2] + _mul32(v[0], v[1])) & _M32
        v[3] = (v[3] + _mul32(v[1], v[2])) & _M32
        if round_ == 0:
            v = [x ^ (x >> 16) for x in v]
    return v


def uniform(word: torch.Tensor, dtype) -> torch.Tensor:
    return torch.clamp(word.to(torch.float32) * (2.0 ** -32), max=_ONE_MINUS).to(dtype)


def stream_word(seed: int, wave: int) -> int:
    """The stream word of wave `wave` of a render seeded `seed`."""
    return ((int(seed) & _M32) * 0x9E3779B9 + (int(wave) & _M32) * 0x85EBCA6B) & _M32


# --------------------------------------------------------------- scene -----

@dataclasses.dataclass(frozen=True)
class Transport:
    sigma_a: float
    sigma_s: float
    g: float
    le_scale: float
    temperature_offset: float
    temperature_scale: float
    infinite_xyz: Tuple[float, float, float]
    infinite_multiplier: float
    distant_xyz: Tuple[float, float, float]
    distant_multiplier: float
    distant_inv_direction: Tuple[float, float, float]
    max_depth: int
    super_tau: float = 8.0

    @property
    def sigma_t(self) -> float:
        return self.sigma_a + self.sigma_s


@dataclasses.dataclass(frozen=True)
class Grid:
    """A dense grid: voxel (i, j, k) of `data` sits at index origin + (i, j, k),
    world = index * voxel + offset."""
    data: torch.Tensor
    origin: Tuple[int, int, int]
    voxel: float
    offset: Tuple[float, float, float]


def majorants(density: torch.Tensor, bloat: float = 0.0):
    """(brick, superbrick-per-brick) majorants, each [BX, BY, BZ]."""
    X, Y, Z = density.shape
    nb = [-(-s // BRICK) for s in (X, Y, Z)]
    pad = []
    for s, b in zip((Z, Y, X), nb[::-1]):
        pad += [1, b * BRICK - s + 1]
    p = F.pad(density.float()[None, None], pad)  # zero halo: densities are >= 0
    brick = F.max_pool3d(p, kernel_size=BRICK + 2, stride=BRICK)[0, 0]
    brick = torch.clamp(brick, min=0.0)
    if bloat:
        brick = brick * (1.0 + bloat)
    ns = [-(-b // SUPER) for b in nb]
    sp = F.pad(brick[None, None], [0, ns[2] * SUPER - nb[2], 0, ns[1] * SUPER - nb[1], 0, ns[0] * SUPER - nb[0]])
    sup = F.max_pool3d(sp, kernel_size=SUPER, stride=SUPER)[0, 0]
    sup_b = sup.repeat_interleave(SUPER, 0).repeat_interleave(SUPER, 1).repeat_interleave(SUPER, 2)
    return brick, sup_b[:nb[0], :nb[1], :nb[2]].contiguous()


class Volume:
    """The medium as the reference reads it, in `dtype`."""

    def __init__(self, density: Grid, transport: Transport, temperature: Optional[Grid] = None,
                 bloat: float = 0.0, dtype=torch.float32):
        self.t = transport
        self.dtype = dtype
        self.density = density
        self.shape = tuple(density.data.shape)
        dev = density.data.device
        self.device = dev
        self.dpad = F.pad(density.data.float(), (1, 1, 1, 1, 1, 1)).to(dtype).contiguous()
        bm, sm = majorants(density.data, bloat)
        self.nb = tuple(bm.shape)
        self.bmaj = bm.reshape(-1).to(dtype)
        self.smaj = sm.reshape(-1).to(dtype)
        self.emits = temperature is not None and transport.le_scale != 0.0
        self.temperature = temperature
        if self.emits:
            self.tpad = F.pad(temperature.data.float(), (1, 1, 1, 1, 1, 1)).to(dtype).contiguous()
            self.tshape = tuple(temperature.data.shape)
            t_max = float(temperature.data.max()) * transport.temperature_scale + transport.temperature_offset
            self.blackbody = Blackbody(t_max, dev, dtype)
        wi = np.asarray(transport.distant_inv_direction, np.float32)
        wi = wi / np.float32(np.linalg.norm(wi))
        self.wi = [float(v) for v in wi.astype(np.float32)]
        self.wi_inv = [_safe_inv_scalar(v) for v in self.wi]
        self.Li = [_f32(np.float32(c) * np.float32(transport.distant_multiplier)) for c in transport.distant_xyz]
        self.Linf = [_f32(np.float32(c) * np.float32(transport.infinite_multiplier)) for c in transport.infinite_xyz]
        self.nee = any(c * transport.distant_multiplier != 0.0 for c in transport.distant_xyz)


def _safe_inv_scalar(v: float) -> float:
    v = np.float32(v)
    if v == 0:
        return 1e12
    return float(np.sign(v) * (np.float32(1.0) / np.float32(max(abs(v), np.float32(1e-12)))))


class Pinhole:
    """The reference renderer's pinhole camera for a W x H raster."""

    def __init__(self, position, look, up, vfov_deg: float, width: int, height: int, device, dtype=torch.float32):
        pos = np.asarray(position, np.float64)
        fwd = np.asarray(look, np.float64) - pos
        fwd /= np.linalg.norm(fwd)
        upn = np.asarray(up, np.float64) / np.linalg.norm(up)
        left = np.cross(upn, fwd)
        frame = np.stack([left, np.cross(fwd, left), fwd], axis=1)
        tan_half = math.tan(math.radians(vfov_deg) / 2.0)
        sx, sy = (width / height) * tan_half, tan_half
        # raster (x, y) -> screen (1 - 2x/W, 1 - 2y/H) -> camera (sx * ., sy * ., 1)
        mx = frame @ np.array([-2.0 * sx / width, 0.0, 0.0])
        my = frame @ np.array([0.0, -2.0 * sy / height, 0.0])
        tr = frame @ np.array([sx, sy, 1.0])
        f = lambda a: torch.tensor(np.asarray(a, np.float32), device=device).to(dtype)  # noqa: E731
        self.pos, self.mx, self.my, self.tr = f(pos), f(mx), f(my), f(tr)
        self.width, self.height, self.dtype = width, height, dtype

    def rays(self, pids: torch.Tensor, streams: torch.Tensor, jitter: float = 0.5):
        """World rays (origins, unit directions) [N, 3] of pixel ids under their stream words."""
        r = pcg4d(pids, streams, torch.full_like(pids, JITTER_CTR), torch.zeros_like(pids))
        jx = uniform(r[0], self.dtype) * jitter
        jy = uniform(r[1], self.dtype) * jitter
        py = pids // self.width
        px = pids - py * self.width
        ptx = (px.to(self.dtype) + 0.5) + jx
        pty = (py.to(self.dtype) + 0.5) + jy
        d = ptx[:, None] * self.mx + pty[:, None] * self.my + self.tr
        d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
        return self.pos.expand_as(d), d


# ---------------------------------------------------------------- walk -----

def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    inv = torch.sign(d) * (1.0 / torch.clamp(d.abs(), min=1e-12))
    return torch.where(d == 0, torch.full_like(d, 1e12), inv)


def _clip(o, inv, lo, hi):
    ta = (lo - o) * inv
    tb = (hi - o) * inv
    t0 = torch.clamp(torch.minimum(ta, tb).amax(-1), min=1e-4)
    t1 = torch.maximum(ta, tb).amin(-1)
    return t0, t1, t0 < t1


_CORNERS = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]


def _trilinear_setup(lp: torch.Tensor, shape):
    """(flat padded corner indices [N, 8], weights [N, 8], base validity [N])."""
    i = torch.floor(lp).long()
    f = lp - i.to(lp.dtype)
    X, Y, Z = shape
    valid = (i[:, 0] >= -1) & (i[:, 0] <= X - 1) & (i[:, 1] >= -1) & (i[:, 1] <= Y - 1) \
        & (i[:, 2] >= -1) & (i[:, 2] <= Z - 1)
    ic = torch.stack([torch.clamp(i[:, 0] + 1, 0, X), torch.clamp(i[:, 1] + 1, 0, Y),
                      torch.clamp(i[:, 2] + 1, 0, Z)], -1)
    g = 1.0 - f
    fx, fy, fz = f.unbind(-1)
    gx, gy, gz = g.unbind(-1)
    w = torch.stack([gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
                     fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz], -1)
    idx = torch.stack([((ic[:, 0] + a) * (Y + 2) + ic[:, 1] + b) * (Z + 2) + ic[:, 2] + c for a, b, c in _CORNERS], -1)
    return idx, w, valid


def _dot8(v, w):
    s = v[:, 0] * w[:, 0] + v[:, 1] * w[:, 1]
    for c in range(2, 8):
        s = s + v[:, c] * w[:, c]
    return s


@dataclasses.dataclass
class WalkResult:
    L: torch.Tensor  # [N, 3] XYZ radiance
    steps: torch.Tensor  # [N] steps each lane took
    capped: torch.Tensor  # [N] bool: still walking at max_iters
    t_final: Optional[torch.Tensor] = None  # [N, K] each shadow walk's final transmittance
    grad: Optional[torch.Tensor] = None  # [X, Y, Z] gradient of <g, L> w.r.t. the density


def init_lanes(vol: Volume, o_world, d_world):
    dt = vol.dtype
    d = d_world.to(dt)
    off = torch.tensor(vol.density.offset, device=vol.device, dtype=torch.float32).to(dt)
    voxel = torch.tensor(vol.density.voxel, device=vol.device, dtype=torch.float32).to(dt)
    o = (o_world.to(dt) - off) / voxel
    lo = torch.tensor(vol.density.origin, device=vol.device, dtype=dt)
    hi = lo + torch.tensor(vol.shape, device=vol.device, dtype=dt)
    inv = _safe_inv(d)
    t0, t1, hit = _clip(o, inv, lo, hi)
    zero = torch.zeros_like(t0)
    t = torch.where(hit, t0, zero)
    Linf = torch.tensor(vol.Linf, device=vol.device, dtype=dt)
    return dict(
        o=o, d=d, inv=inv, t=t, t_exit=torch.where(hit, t1, zero), sig_seg=zero.clone(), t_seg=t.clone(),
        L=torch.where(hit[:, None], torch.zeros_like(o), Linf.expand_as(o)),
        po=o.clone(), pd=d.clone(), T=torch.ones_like(t0), phase=zero.clone(),
        depth=torch.zeros_like(t0, dtype=torch.int32), mode=torch.where(hit, CAM, DONE).to(torch.int32),
        ctr=torch.zeros_like(t0, dtype=torch.int64), wc=torch.zeros_like(t0, dtype=torch.int64),
    )


def walk(vol: Volume, o_world: torch.Tensor, d_world: torch.Tensor, pids: torch.Tensor, streams: torch.Tensor,
         max_iters: int, record_walks: int = 0, replay=None, touched: Optional[dict] = None) -> WalkResult:
    """Walk every lane until it retires or has taken max_iters steps.

    pids, streams: [N] int64 pixel ids and stream words. record_walks: K, the
    shadow-walk slots kept per lane (t_final). replay: (g [N, 3], L [N, 3],
    t_final [N, K]) of a recorded walk: walk again and return the gradient.
    touched: dict of int32 tensors 'corners' [(X+1)(Y+1)(Z+1)], 'bricks' [NB]
    and, for an emitting volume, 'tcorners', counting the lanes' reads.
    """
    tp = vol.t
    dt = vol.dtype
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

    st = init_lanes(vol, o_world, d_world)
    st["pid"] = pids.to(torch.int64) & _M32
    st["strm"] = streams.to(torch.int64) & _M32
    st["lane"] = torch.arange(N, device=dev)
    out_L = torch.zeros((N, 3), device=dev, dtype=dt)
    out_steps = torch.zeros((N,), device=dev, dtype=torch.int64)
    out_capped = torch.zeros((N,), device=dev, dtype=torch.bool)
    t_final = torch.zeros((N, record_walks), device=dev, dtype=dt) if record_walks else None
    grad = None
    if replay is not None:
        g_vec, L_tot, tf_rec = replay
        grad = torch.zeros(((X + 2) * (Y + 2) * (Z + 2),), device=dev, dtype=torch.float32)
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
        if vol.emits:
            tl = ((pc * voxel + d_off) - t_off) / t_vox - t_org
            tidx, tw, tvalid = _trilinear_setup(tl, vol.tshape)
            temp = torch.where(tvalid & cam_col, _dot8(vol.tpad.reshape(-1)[tidx], tw), torch.zeros_like(t))
            kelvin = temp * tp.temperature_scale + tp.temperature_offset
            emit = (p_a * tp.le_scale)[:, None] * vol.blackbody(kelvin)
            L = L + torch.where(cam_col[:, None], emit, torch.zeros_like(emit))
            if touched is not None:
                tb = tidx[:, 0]
                TY, TZ = vol.tshape[1], vol.tshape[2]
                tx, trem = tb // ((TY + 2) * (TZ + 2)), tb % ((TY + 2) * (TZ + 2))
                trow = (tx * (TY + 1) + trem // (TZ + 2)) * (TZ + 1) + trem % (TZ + 2)
                touched["tcorners"].index_add_(0, trow, (cam_col & tvalid).int())
        xv = u1 * (p_n + p_a + p_s)
        event = torch.where(xv <= p_n, 0, torch.where(xv <= p_n + p_a, 1, 2))
        cam_null = cam_col & (event == 0)
        cam_abs = cam_col & (event == 1)
        cam_scat = cam_col & (event == 2)

        if replay is not None:
            # the score of the event times <g, radiance at and after it>
            score = torch.where(cam_null, -(tp.sigma_a + tp.sigma_s) * rsig / torch.clamp(p_n, min=1e-20),
                                torch.where(cam_scat, 1.0 / torch.clamp(rho, min=1e-20), torch.zeros_like(rho)))
            coef = score * (st["gsuf"] - (st["gv"] * L).sum(-1))
            # ratio tracking: T_final * phase * <g, Li> * d log(sigma_n) / d rho
            shw_hit = in_shw & real_col
            slot = torch.clamp(st["wc"] - 1, 0, max(tf_rec.shape[1] - 1, 0))
            tfin = tf_rec[st["lane"], slot].to(dt) if tf_rec.shape[1] else torch.zeros_like(t)
            sig_n = st["sig_seg"] - sigma_t * rho
            coef = coef + torch.where(shw_hit & (sig_n > 0) & (tfin > 0),
                                      st["phase"] * tfin * st["gLi"] * (-sigma_t) / torch.clamp(sig_n, min=1e-20),
                                      torch.zeros_like(rho))
            coef = torch.where(valid, coef, torch.zeros_like(coef))
            grad.index_add_(0, cidx.reshape(-1), (coef[:, None] * w8).reshape(-1).float())

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
        if record_walks:
            rec = shadow_finish & (st["wc"] >= 1) & (st["wc"] <= record_walks)
            at = (st["lane"], torch.clamp(st["wc"] - 1, 0, record_walks - 1))
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

        # A retired lane's radiance, mode and walk count no longer change
        # (every update above is gated by its mode), so only the counter is masked.
        st.update(o=o_new, d=d_new, inv=inv_new, t=t_new, t_exit=t_exit, sig_seg=sig_seg, t_seg=t_seg, L=L,
                  po=po, pd=pd, T=T, phase=phase, depth=depth, mode=mode,
                  ctr=st["ctr"] + active.long(), wc=st["wc"] + start_ok.long())
    res = WalkResult(L=out_L, steps=out_steps, capped=out_capped, t_final=t_final)
    if grad is not None:
        res.grad = grad.view(X + 2, Y + 2, Z + 2)[1:-1, 1:-1, 1:-1].contiguous()
    return res
