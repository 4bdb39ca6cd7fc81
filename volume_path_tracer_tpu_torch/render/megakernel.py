"""The forward tracer's lane loop: a CUDA kernel for Hopper and its plain twin.

Replaces the JAX package's Pallas megakernel (volume_path_tracer_tpu/render/
megakernel.py: the event-step kernel of make_kernel, launched by
_pallas_step_call from trace_rays_fused) together with its XLA prestep
(make_prestep / fetch_rows). The kernel, csrc/trace_lanes.cu, carries each
lane through draws, free flight, the fused-row gather, the trilinear dot,
blackbody emission and the event step, for up to `max_steps` steps, with
its state in registers. Its notes say what bounds it and what the
persistent-lane design costs.

  trace_lanes        the wrapper: on CUDA tensors it launches the kernel (or
                     raises); on CPU tensors it runs the plain version.
  trace_lanes_plain  the plain version: the port's one plain loop
                     (integrator.advance_lanes over make_step).
  trace_rays_fused   the production forward tracer, same contract as
                     integrator.trace_rays: one launch with
                     max_steps = params.max_iters.

LAUNCHES and PLAIN_LAUNCHES count the launches of each, so a run can show
which one its main path went through.

The kernel is compiled with nvcc at first use, from the checkout's own
source, into volume_path_tracer_tpu_torch/_build/ (one library per source
content), and loaded with ctypes: a plain C interface, no PyTorch headers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.medium import Medium
from ..ops.phase import INV_4PI
from ..utils.spectral import RESOLUTION, blackbody_pairs
from .integrator import (
    DONE,
    IntegratorParams,
    RayState,
    advance_lanes,
    emission_enabled,
    init_state,
    lane_streams,
    light_constants,
    make_step,
)

# Per-lane SoA state, in the kernel's field order.
STATE_F32 = (
    "ox", "oy", "oz", "dx", "dy", "dz", "t", "t_exit", "sig_seg", "t_seg",
    "Lx", "Ly", "Lz", "pox", "poy", "poz", "pdx", "pdy", "pdz",
    "T_ray", "phase_val",
)
STATE_I32 = ("depth", "mode", "ctr")

LAUNCHES = 0  # kernel launches (trace_lanes on CUDA tensors)
PLAIN_LAUNCHES = 0  # plain-version runs (trace_lanes_plain)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "trace_lanes.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None


# ---------------------------------------------------------------- state ----

def pack_state(st: RayState) -> Tuple[torch.Tensor, torch.Tensor]:
    """RayState -> (sf [21, N] float32, si [3, N] int32), SoA."""
    f = [st.o[:, 0], st.o[:, 1], st.o[:, 2], st.d[:, 0], st.d[:, 1], st.d[:, 2],
         st.t, st.t_exit, st.sig_seg, st.t_seg, st.L[:, 0], st.L[:, 1], st.L[:, 2],
         st.pend_o[:, 0], st.pend_o[:, 1], st.pend_o[:, 2],
         st.pend_d[:, 0], st.pend_d[:, 1], st.pend_d[:, 2], st.T_ray, st.phase_val]
    sf = torch.stack(f).to(torch.float32).contiguous()
    si = torch.stack([st.depth, st.mode, st.ctr]).to(torch.int32).contiguous()
    return sf, si


def unpack_state(sf: torch.Tensor, si: torch.Tensor) -> RayState:
    """(sf, si) -> RayState; wscore 1 and terminated False, which the SoA
    state does not carry (the forward render reads neither)."""
    n = sf.shape[1]
    return RayState(
        o=sf[0:3].T.contiguous(), d=sf[3:6].T.contiguous(), t=sf[6], t_exit=sf[7],
        sig_seg=sf[8], t_seg=sf[9], L=sf[10:13].T.contiguous(),
        wscore=torch.ones((n,), dtype=torch.float32, device=sf.device),
        depth=si[0], mode=si[1],
        terminated=torch.zeros((n,), dtype=torch.bool, device=sf.device),
        pend_o=sf[13:16].T.contiguous(), pend_d=sf[16:19].T.contiguous(),
        T_ray=sf[19], phase_val=sf[20], ctr=si[2],
    )


def _as_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int32 holding its low 32 bits (uint32 >= 2^31 wrap)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32).contiguous()


# -------------------------------------------------------- plain version ----

def trace_lanes_plain(
    medium: Medium, params: IntegratorParams, bb_table: Optional[torch.Tensor],
    sf: torch.Tensor, si: torch.Tensor, pixel_ids: torch.Tensor, streams: torch.Tensor,
    max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: every lane advances until DONE or
    `max_steps` steps, by the plain tracer's loop (integrator.advance_lanes).

    A lane that is DONE takes no step and keeps its counter, as in the
    kernel. Returns new (sf, si).
    """
    global PLAIN_LAUNCHES
    PLAIN_LAUNCHES += 1
    st = advance_lanes(make_step(medium, params, bb_table), unpack_state(sf, si),
                       pixel_ids, streams, max_steps)
    return pack_state(st)


# --------------------------------------------------------------- kernel ----

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found; set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> str:
    """Compile csrc/trace_lanes.cu (once per source content) and return the
    library's path. The compiler's report (registers, spills) is kept beside
    it in a .log file."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"libtrace_lanes-{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{r.stdout}\n{r.stderr}")
    with open(out + ".log", "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vpt_trace_lanes.argtypes = [i, p, p, p, p, p, i, i, p, ll, i, p, ll, p, p, p, p]
        lib.vpt_trace_lanes.restype = i
        lib.vpt_error_string.argtypes = [i]
        lib.vpt_error_string.restype = ctypes.c_char_p
        lib.vpt_num_fparams.restype = i
        lib.vpt_num_iparams.restype = i
        _lib = lib
    return _lib


def _kernel_params(medium: Medium, params: IntegratorParams, n_pairs: int, emission: int):
    """(fp float32, ip int32) host arrays in the kernel's FParam / IParam order."""
    dg, tg = medium.density, medium.temperature
    g = params.hg_g
    wi, Li, L_inf = (v.numpy() for v in light_constants(params))
    nbb = n_pairs + 1
    fp = [
        dg.voxel_size, params.sigma_a, params.sigma_s, params.sigma_t, g,
        params.super_tau, params.le_scale, params.temperature_scale,
        params.temperature_offset,
        1.0 + g * g, 2.0 * g, INV_4PI * (1.0 - g * g),
        *wi, *Li, *L_inf, *dg.world_offset,
        *(tg.world_offset if tg is not None else (0.0, 0.0, 0.0)),
        tg.voxel_size if tg is not None else 1.0,
        (nbb - 1) * RESOLUTION - 1e-3,
        *dg.origin_ijk,
        *(tg.origin_ijk if tg is not None else (0, 0, 0)),
        RESOLUTION,
    ]
    BX, BY, BZ = medium.majorants.brick_maj.shape
    ip = [
        *dg.shape, BX, BY, BZ, min(int(params.max_depth), 2**31 - 1),
        int(params.nee_enabled), emission,
        *(tg.shape if tg is not None else (0, 0, 0)), max(n_pairs, 1),
    ]
    return np.asarray(fp, np.float32), np.asarray(ip, np.int32)


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def trace_lanes(
    medium: Medium, params: IntegratorParams, bb_table: Optional[torch.Tensor],
    sf: torch.Tensor, si: torch.Tensor, pixel_ids: torch.Tensor, streams: torch.Tensor,
    max_steps: int, row_tap: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance every lane until DONE or `max_steps` steps; returns new (sf, si).

    sf [21, N] float32 and si [3, N] int32 are the SoA state (STATE_F32,
    STATE_I32), pixel_ids and streams [N] integer (uint32 values). On CUDA
    tensors this launches csrc/trace_lanes.cu once, or raises; on CPU
    tensors it runs trace_lanes_plain. row_tap (CUDA only, for measurement):
    a zeroed uint8 [R + R_t] tensor in which the kernel marks every row of
    density_rows (then of temperature_rows, if read) that it reads.
    """
    if sf.device.type == "cpu":
        return trace_lanes_plain(medium, params, bb_table, sf, si, pixel_ids, streams, max_steps)
    if sf.device.type != "cuda":
        raise ValueError(f"trace_lanes: unsupported device {sf.device}")
    dev = sf.device
    n = sf.shape[1]
    _check(sf, "sf", torch.float32, (len(STATE_F32), n), dev)
    _check(si, "si", torch.int32, (len(STATE_I32), n), dev)
    rows = medium.density_rows
    if rows is None:
        raise ValueError(
            "the CUDA tracer needs the fused row table: build the medium "
            "with Medium.from_grids(..., pack=True)"
        )
    if rows.device != dev or rows.dtype != torch.float32 or not rows.is_contiguous() \
            or rows.shape[1] not in (8, 16) or rows.data_ptr() % 16:
        raise ValueError("density_rows must be a contiguous, 16-byte aligned "
                         f"float32 [R, 8 or 16] table on {dev}")
    emission = 0
    trows = None
    pairs = None
    if emission_enabled(medium, params):
        if bb_table is None:
            raise ValueError("an emissive medium needs the blackbody table")
        pairs = blackbody_pairs(torch.as_tensor(bb_table, dtype=torch.float32, device=dev)).contiguous()
        if rows.shape[1] >= 16:
            emission = 1
        else:
            emission = 2
            trows = medium.temperature_rows
            if trows is None or trows.device != dev or not trows.is_contiguous() \
                    or trows.data_ptr() % 16:
                raise ValueError("an 8-wide emissive medium needs its temperature "
                                 f"corner rows as a contiguous table on {dev}")
    n_pairs = pairs.shape[0] if pairs is not None else 0
    fp_np, ip_np = _kernel_params(medium, params, n_pairs, emission)
    lib = _library()
    if fp_np.size != lib.vpt_num_fparams() or ip_np.size != lib.vpt_num_iparams():
        raise RuntimeError("kernel parameter layout mismatch with csrc/trace_lanes.cu")
    fp = torch.from_numpy(fp_np).pin_memory().to(dev, non_blocking=True)
    ip = torch.from_numpy(ip_np).pin_memory().to(dev, non_blocking=True)
    pids = _as_i32_bits(pixel_ids.to(dev))
    strm = _as_i32_bits(streams.to(dev))
    _check(pids, "pixel_ids", torch.int32, (n,), dev)
    _check(strm, "streams", torch.int32, (n,), dev)
    n_trows = trows.shape[0] if trows is not None else 0
    if row_tap is not None:
        _check(row_tap, "row_tap", torch.uint8, (rows.shape[0] + n_trows,), dev)
    sf = sf.clone()
    si = si.clone()

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = lib.vpt_trace_lanes(
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
        sf.data_ptr(), si.data_ptr(), pids.data_ptr(), strm.data_ptr(),
        n, int(max_steps), rows.data_ptr(), rows.shape[0], rows.shape[1],
        ptr(trows), n_trows, ptr(pairs), fp.data_ptr(), ip.data_ptr(), ptr(row_tap),
    )
    if err != 0:
        raise RuntimeError(f"trace_lanes launch failed: {lib.vpt_error_string(err).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    return sf, si


# -------------------------------------------------------------- tracer ----

def trace_rays_fused(
    medium: Medium,
    params: IntegratorParams,
    bb_table: Optional[torch.Tensor],
    o_world: torch.Tensor,
    d_world: torch.Tensor,
    pixel_ids: torch.Tensor,
    stream,
):
    """Forward render of a ray batch through trace_lanes; same contract as
    integrator.trace_rays: (radiance [N, 3], iterations, n_capped), the last
    two as 0-d tensors (iterations = the largest lane counter). No host
    synchronisation."""
    st0 = init_state(medium, o_world, d_world, params)
    sf, si = pack_state(st0)
    n = sf.shape[1]
    streams = lane_streams(stream, n, sf.device)
    sf, si = trace_lanes(medium, params, bb_table, sf, si, pixel_ids, streams, params.max_iters)
    L = sf[10:13].T
    if n == 0:
        zero = torch.zeros((), dtype=torch.int64, device=sf.device)
        return L, zero, zero
    return L, si[2].max().to(torch.int64), (si[1] != DONE).sum()
