"""The forward tracer's lane loop: CUDA kernels for Hopper and their plain twins.

Replaces the JAX package's Pallas megakernel (volume_path_tracer_tpu/render/
megakernel.py: the event-step kernel of make_kernel, launched by
_pallas_step_call from trace_rays_fused) together with its XLA prestep
(make_prestep / fetch_rows). csrc/trace_lanes.cu holds one step function and
one warp loop (persistent warps that refill retired lanes from a queue) and
two kernels around them; its notes say what bounds them on the card. Each
kernel has a second instantiation for a medium without the fused table
(Medium.from_grids(pack=False)): the same step, reading the grids' own
density and temperature arrays (dense_arrays) and the majorant pairs.

  render_wave        the renderer's wave: one launch makes each pixel's
                     camera ray, traces it and adds its sample to the film.
                     On CUDA tensors it launches render_wave_kernel (or
                     raises); on CPU tensors it runs render_wave_plain.
  render_wave_plain  its plain version: counter_uniforms -> generate_rays ->
                     init_state -> advance_lanes -> film add.
  trace_lanes        state in, state out, for arbitrary ray batches and for
                     max_steps = 1 (the one-step check): trace_lanes_kernel
                     on CUDA tensors, trace_lanes_plain on CPU tensors.
  trace_lanes_plain  its plain version: the port's one plain loop
                     (integrator.advance_lanes over make_step).
  trace_rays_fused   a ray batch through trace_lanes, same contract as
                     integrator.trace_rays.

The gradient path (diff/prb.py trace_rays_prb) has two more:

  record_lanes       the forward of a train step: the record instantiation
                     of trace_lanes_kernel, whose lanes are born from the
                     world rays in the kernel, run the same lane step, record
                     each NEE walk's residual and end as their radiance and
                     last counter; on CPU tensors its plain version, diff/
                     prb.py _trace_rays_record's loop.
  replay_lanes       the backward: replay_lanes_kernel walks each lane's path
                     again from its world ray and draw counters, taking the
                     lanes in a given queue order (longest_first of the
                     record's counters), and adds each event's gradient
                     straight into the [X, Y, Z] gradient grids with float
                     atomics: no corner-row table and no fold. On CPU
                     tensors its plain version, diff/prb.py replay_grads,
                     which scatters into corner-row tables and folds them
                     (prb.fold_corner_rows), as the JAX package does.

and the train step (diff/inverse.py make_train_step) one:

  loss_rays          the ray batch of one loss evaluation: on CUDA tensors
                     one launch of loss_rays_kernel makes each lane's stream
                     word, jitter and camera ray, with nothing copied from
                     the host; on CPU tensors loss_rays_plain, in torch.

WAVE_LAUNCHES, LAUNCHES, RECORD_LAUNCHES, REPLAY_LAUNCHES, LOSS_RAYS_LAUNCHES
and the PLAIN_* counters of the plain versions count the launches of each,
and the DENSE_* counters those of the dense instantiations among them, so a
run can show which one its main path went through.

The kernels are compiled with nvcc at first use, from the checkout's own
source, into volume_path_tracer_tpu_torch/_build/ (one library per source
content), and loaded with ctypes: a plain C interface, no PyTorch headers.
What a scene gives the kernels (the parameter arrays, the blackbody pairs,
the launch scratch) is made once and kept (kernel_constants): per (medium,
params, camera) for a camera's launches, per the medium's geometry and
params for the others, so a train step that rebuilds its medium reuses it.
C_SIGNATURES is the C interface, in one table that the library is bound by.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
import weakref
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..diff.prb import (
    MAX_RECORD_ITERS,
    dot3,
    record_state,
    replay_grads,
    replay_iteration_cap,
)
from ..models.camera import Camera
from ..models.medium import Medium
from ..ops.phase import INV_4PI
from ..utils import rng as vrng
from ..utils.spans import span
from ..utils.spectral import RESOLUTION, blackbody_pairs
from .integrator import (
    DONE,
    IntegratorParams,
    RayState,
    _safe_inv,
    advance_lanes,
    count_capped,
    emission_enabled,
    finalize_radiance,
    init_state,
    inv_voxel,
    lane_iterations,
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

# Jitter draws use a counter no tracing step reaches.
JITTER_COUNTER = 2**31 - 1

WAVE_LAUNCHES = 0  # render_wave_kernel launches (render_wave on CUDA tensors)
LAUNCHES = 0  # trace_lanes_kernel launches (trace_lanes on CUDA tensors)
PLAIN_WAVE_LAUNCHES = 0  # plain-version runs (render_wave_plain)
PLAIN_LAUNCHES = 0  # plain-version runs (trace_lanes_plain)
# Those of WAVE_LAUNCHES / LAUNCHES that ran the dense instantiation (a medium
# without the fused table).
DENSE_WAVE_LAUNCHES = 0
DENSE_LAUNCHES = 0
RECORD_LAUNCHES = 0  # trace_lanes_kernel record launches (record_lanes on CUDA tensors)
REPLAY_LAUNCHES = 0  # replay_lanes_kernel launches (replay_lanes on CUDA tensors)
PLAIN_RECORD_LAUNCHES = 0  # plain-version runs (record_lanes_plain)
PLAIN_REPLAY_LAUNCHES = 0  # plain-version runs (replay_lanes_plain)
LOSS_RAYS_LAUNCHES = 0  # loss_rays_kernel launches (loss_rays on CUDA tensors)
PLAIN_LOSS_RAYS_LAUNCHES = 0  # plain-version runs (loss_rays_plain)
DENSE_RECORD_LAUNCHES = 0
DENSE_REPLAY_LAUNCHES = 0

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "trace_lanes.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None

# The C interface of csrc/trace_lanes.cu: name -> (restype, argtypes), which
# _library applies. _P: a pointer (tensor.data_ptr(), the stream, a host
# array), _I: int, _U: unsigned int, _L: long long (a dense array's voxel
# count). A pointer passed where an int stands would be cut to 32 bits, and
# that shows only on the card: tests/test_torch_grad_kernels.py holds this
# table to the source's extern "C" block.
_P, _I, _U, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
# rows, n_rows, row_w, trows, n_trows, bb_pairs, dens, n_dens, maj, n_maj,
# tdata, n_tdata, fp, ip, scratch, tap, stat: the end of every launch's list
_TABLES = (_P, _I, _I, _P, _I, _P, _P, _L, _P, _I, _P, _L, _P, _P, _P, _P, _P)
C_SIGNATURES = {
    "vpt_num_fparams": (_I, ()),
    "vpt_num_iparams": (_I, ()),
    # device, stream, sf, si, pids, streams, n, max_steps
    "vpt_trace_lanes": (_I, (_I, _P, _P, _P, _P, _P, _I, _I, *_TABLES)),
    # device, stream, film, pids, start, n, stream_word, max_steps
    "vpt_render_wave": (_I, (_I, _P, _P, _P, _I, _I, _U, _I, *_TABLES)),
    # the same, counting lane-iterations
    "vpt_render_wave_counted": (_I, (_I, _P, _P, _P, _I, _I, _U, _I, *_TABLES)),
    # device, stream, o_world, o_stride, d_world, pids, streams, n,
    # max_steps, L_out, ctr_out, tf, k_walks
    "vpt_record_lanes": (_I, (_I, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _I, *_TABLES)),
    # device, stream, o_world, o_stride, d_world, pids, streams, order, n,
    # max_steps, max_iters, tf, k_walks, g, Lf, gd, gt, gacc, nsteps
    "vpt_replay_lanes": (_I, (_I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _I,
                              _P, _P, _P, _P, _P, _P, *_TABLES)),
    # device, stream, raster, raster_i64, pids, pids_i64, m, t, seed, wave0,
    # sw, k, n, jitter, d_w, pids_k, stream_k, jit
    "vpt_loss_rays": (_I, (_I, _P, _P, _I, _P, _I, _P, _P, _U, _U, _P, _I, _I, _I, _P, _P, _P, _P)),
    # device, dense, wave_blocks, trace_blocks, threads, sms, record_blocks,
    # replay_blocks
    "vpt_occupancy": (_I, (_I, _I, _P, _P, _P, _P, _P, _P)),
    "vpt_error_string": (ctypes.c_char_p, (_I,)),
}


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




Pixels = Union[range, torch.Tensor]


def _pixel_ids(pixels: Pixels, device) -> torch.Tensor:
    if isinstance(pixels, range):
        if pixels.step != 1:
            raise ValueError("a pixel range must be contiguous")
        return torch.arange(pixels.start, pixels.stop, dtype=torch.int32, device=device)
    return pixels


def render_wave_plain(
    medium: Medium, params: IntegratorParams, camera: Camera, bb_table: Optional[torch.Tensor],
    film: torch.Tensor, pixels: Pixels, stream: int, use_jitter: bool, imaging_ratio: float,
    max_iters: Optional[int] = None, return_lane_iters: bool = False,
):
    """render_wave's plain version, by the port's plain functions:
    counter_uniforms (the jitter) -> Camera.generate_rays -> init_state ->
    advance_lanes -> film[pid] += (imaging_ratio * L, 1). Same contract."""
    global PLAIN_WAVE_LAUNCHES
    PLAIN_WAVE_LAUNCHES += 1
    if max_iters is not None:
        params = dataclasses.replace(params, max_iters=max_iters)
    dev = film.device
    width = film.shape[1]
    pids = _pixel_ids(pixels, dev)
    n = pids.shape[0]
    raster = torch.stack([pids % width, pids // width], dim=-1)
    u_jit = vrng.counter_uniforms(pids, stream, JITTER_COUNTER, 2)
    jitter = u_jit * (0.5 if use_jitter else 0.0)  # half-pixel jitter quirk
    o_w, d_w = camera.generate_rays(raster, jitter)
    st = advance_lanes(make_step(medium, params, bb_table), init_state(medium, o_w, d_w, params),
                       pids, lane_streams(stream, n, dev), params.max_iters)
    contrib = torch.cat(
        [imaging_ratio * st.L, torch.ones((n, 1), dtype=torch.float32, device=dev)], dim=-1
    )
    flat = film.view(-1, 4)
    if isinstance(pixels, range):
        flat[pixels.start:pixels.stop] += contrib
    else:
        flat[pids.to(torch.int64)] += contrib
    iters = st.ctr.max() if n else torch.zeros((), dtype=torch.int32, device=dev)
    if return_lane_iters:
        return iters, count_capped(st), lane_iterations(st)
    return iters, count_capped(st)


# -------------------------------------------------------------- kernels ----

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found; set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(source: Optional[str] = None) -> str:
    """Compile `source` (default SOURCE, csrc/trace_lanes.cu) once per source
    content and return the library's path. The compiler's report
    (registers, spills) is kept beside it in a .log file. Builds of
    different sources may run at once (one nvcc each)."""
    source = source or SOURCE
    with open(source, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"libtrace_lanes-{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    r = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, source], capture_output=True, text=True
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{r.stdout}\n{r.stderr}")
    with open(out + ".log", "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        with span("kernel.build"):
            lib = ctypes.CDLL(build())
        for name, (restype, argtypes) in C_SIGNATURES.items():
            # A variant of the source timed by chip_smoke.py --variants may
            # lack a function; it is then never called.
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.restype, fn.argtypes = restype, list(argtypes)
        _lib = lib
    return _lib


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed: {_library().vpt_error_string(err).decode()}")


class Occupancy(NamedTuple):
    """Resident blocks of each production kernel on a device, as the CUDA
    runtime computes them (a launch starts at most these), threads per block
    and the SM count."""

    wave: int  # render_wave_kernel
    trace: int  # trace_lanes_kernel
    threads: int
    sms: int
    record: int  # trace_lanes_kernel's record instantiation
    replay: int  # replay_lanes_kernel


def occupancy(device: torch.device, dense: bool = False) -> Occupancy:
    """The Occupancy of the packed or the dense instantiations on `device`."""
    out = [ctypes.c_int(0) for _ in range(6)]
    err = _library().vpt_occupancy(device.index or 0, int(dense), *(ctypes.byref(v) for v in out))
    _raise_on(err, "occupancy query")
    return Occupancy(*(v.value for v in out))


def _param_fields(medium: Medium, params: IntegratorParams, n_pairs: int, emission: int,
                  camera: Optional[Camera], width: int, use_jitter: bool, imaging_ratio: float):
    """The kernel's parameters as ([(name, values)], [(name, values)]) in the
    order of csrc/trace_lanes.cu's enum FParam / enum IParam; a name with
    three values is a vector whose later slots the kernel reads as name + 1,
    name + 2. The camera fields are zero where there is no camera
    (trace_lanes reads none of them)."""
    dg, tg = medium.density, medium.temperature
    g = params.hg_g
    wi, Li, L_inf = light_constants(params)
    zero3 = (0.0, 0.0, 0.0)
    if camera is not None:
        cam_pos = camera.position.cpu().numpy()
        cam_m = camera.raster_to_world_dir.cpu().numpy()
        cam_t = camera.raster_to_world_trans.cpu().numpy()
    else:
        cam_pos, cam_m, cam_t = np.zeros(3), np.zeros((3, 3)), np.zeros(3)
    fields_f = [
        ("P_VOXEL", dg.voxel_size), ("P_INV_VOXEL", inv_voxel(dg.voxel_size)), ("P_SIGMA_A", params.sigma_a), ("P_SIGMA_S", params.sigma_s),
        ("P_SIGMA_T", params.sigma_t), ("P_G", g), ("P_SUPER_TAU", params.super_tau),
        ("P_LE_SCALE", params.le_scale), ("P_T_SCALE", params.temperature_scale),
        ("P_T_OFFSET", params.temperature_offset),
        ("P_HG_DEN0", 1.0 + g * g), ("P_HG_C1", 2.0 * g), ("P_HG_NUM", INV_4PI * (1.0 - g * g)),
        ("P_WI", wi.numpy()), ("P_WI_INV", _safe_inv(wi).numpy()),
        ("P_LI", Li.numpy()), ("P_LINF", L_inf.numpy()),
        ("P_DOFF", dg.world_offset), ("P_TOFF", tg.world_offset if tg is not None else zero3),
        ("P_TVOXEL", tg.voxel_size if tg is not None else 1.0),
        ("P_TC_MAX", n_pairs * RESOLUTION - 1e-3),
        ("P_ORIGIN", dg.origin_ijk), ("P_TORIGIN", tg.origin_ijk if tg is not None else zero3),
        ("P_BB_RES", RESOLUTION),
        ("P_CAM_POS", cam_pos), ("P_CAM_MX", cam_m[:, 0]), ("P_CAM_MY", cam_m[:, 1]),
        ("P_CAM_T", cam_t), ("P_IMG_RATIO", imaging_ratio),
        ("P_JITTER", 0.5 if use_jitter else 0.0),  # half-pixel jitter quirk
    ]
    bx, by, bz = medium.majorants.brick_maj.shape
    tshape = tg.shape if tg is not None else (0, 0, 0)
    fields_i = [
        ("I_X", dg.shape[0]), ("I_Y", dg.shape[1]), ("I_Z", dg.shape[2]),
        ("I_BX", bx), ("I_BY", by), ("I_BZ", bz),
        ("I_MAX_DEPTH", min(int(params.max_depth), 2**31 - 1)),
        ("I_NEE", int(params.nee_enabled)), ("I_EMISSION", emission),
        ("I_TX", tshape[0]), ("I_TY", tshape[1]), ("I_TZ", tshape[2]),
        ("I_NPAIRS", max(n_pairs, 1)), ("I_WIDTH", max(int(width), 1)),
    ]
    return fields_f, fields_i


def param_layout(fields):
    """({name: offset}, total length) of a _param_fields list."""
    offsets, at = {}, 0
    for name, values in fields:
        offsets[name] = at
        at += np.size(values)
    return offsets, at


def _flatten(fields, dtype) -> np.ndarray:
    return np.concatenate([np.atleast_1d(np.asarray(v, dtype=dtype)) for _, v in fields])


class KernelConstants(NamedTuple):
    """What one scene gives every launch: the host parameter arrays (they
    travel in the kernel's arguments) and the device tensors that no launch
    changes or that each launch zeroes itself."""

    fp: np.ndarray  # float32, enum FParam order
    ip: np.ndarray  # int32, enum IParam order
    pairs: Optional[torch.Tensor]  # blackbody pair LUT [npairs, 6], emissive media
    scratch: torch.Tensor  # int32 [SCRATCH_INTS]: queue head, n_capped, largest lane counter, -, lane-iterations (int64)
    emission: int  # the kernel's I_EMISSION
    dense: bool  # no fused table: the dense instantiations


# Ints of a launch's scratch (csrc/trace_lanes.cu SCRATCH_INTS): the queue's
# head, n_capped, the largest lane counter, one unused, then render_wave's
# lane-iterations as one 64-bit word (8-byte aligned).
SCRATCH_INTS = 6

# key -> (weak references to the keyed objects, KernelConstants)
_CONSTANTS = {}
# Entries keyed by geometry outlive their media: at most this many are kept,
# the oldest dropped first.
GEOMETRY_ENTRIES = 16


def _geometry(medium: Medium):
    """What the constants of a launch without a camera are made of, beside
    params and the blackbody table: the density and temperature grids' shape,
    origin, offset and voxel size (no data), the brick grid's shape, packed
    or dense and the row width, and the device."""
    def grid(g):
        if g is None:
            return None
        return tuple(g.shape), tuple(g.origin_ijk), tuple(g.world_offset), float(g.voxel_size)

    rows = medium.density_rows
    return (grid(medium.density), grid(medium.temperature), tuple(medium.majorants.brick_maj.shape),
            0 if rows is None else int(rows.shape[1]), medium.temperature_rows is not None,
            str(medium.device))


def kernel_constants(
    medium: Medium, params: IntegratorParams, bb_table: Optional[torch.Tensor],
    camera: Optional[Camera] = None, width: int = 0, use_jitter: bool = False,
    imaging_ratio: float = 0.0,
) -> KernelConstants:
    """The constants of (medium, params, bb_table, camera, ...), built and
    checked at first use and kept.

    With a camera (render_wave) an entry is found by its objects' ids and
    taken only if those ids still name the same live objects, so a new
    Scene's medium, camera or table never meets another's constants; it goes
    with its medium. Without one (trace_lanes, record_lanes, replay_lanes)
    it is found by what the constants are made of (_geometry, params, the
    table's identity) and the medium's tables are checked on every call: a
    train step rebuilds its medium every step and reuses the previous
    step's entry. Launches that share an entry share its scratch: they run
    on one stream.
    """
    if camera is None:
        dense, emission = _layout(medium, params, bb_table)
        objs = (bb_table,)
        key = ("geometry", _geometry(medium), id(bb_table), params)
    else:
        objs = (medium, bb_table, camera)
        key = (*(id(o) for o in objs), params, int(width), bool(use_jitter), float(imaging_ratio))
    hit = _CONSTANTS.get(key)
    if hit is not None and all(r is None if o is None else r() is o for r, o in zip(hit[0], objs)):
        return hit[1]
    with span("kernel.constants"):
        if camera is not None:
            dense, emission = _layout(medium, params, bb_table)
        dev = medium.device
        pairs = None
        if emission:
            pairs = blackbody_pairs(torch.as_tensor(bb_table, dtype=torch.float32, device=dev)).contiguous()
        n_pairs = pairs.shape[0] if pairs is not None else 0
        fields_f, fields_i = _param_fields(medium, params, n_pairs, emission, camera, width,
                                           use_jitter, imaging_ratio)
        consts = KernelConstants(
            fp=_flatten(fields_f, np.float32), ip=_flatten(fields_i, np.int32), pairs=pairs,
            scratch=torch.zeros(SCRATCH_INTS, dtype=torch.int32, device=dev), emission=emission, dense=dense,
        )
        _CONSTANTS[key] = (tuple(None if o is None else weakref.ref(o) for o in objs), consts)
        if camera is not None:
            weakref.finalize(medium, _CONSTANTS.pop, key, None)
        else:
            if bb_table is not None:
                weakref.finalize(bb_table, _CONSTANTS.pop, key, None)
            kept = [k for k in _CONSTANTS if k[0] == "geometry"]
            for old in kept[:-GEOMETRY_ENTRIES]:
                _CONSTANTS.pop(old, None)
        return consts


def kept_constants() -> tuple:
    """Every KernelConstants the cache holds now. A CUDA graph that captured
    launches keeps these alive: its kernels' arguments point into their
    tensors, which the cache may drop."""
    return tuple(entry[1] for entry in _CONSTANTS.values())


def _layout(medium: Medium, params: IntegratorParams, bb_table: Optional[torch.Tensor]):
    """(dense, the kernel's I_EMISSION) of a medium, after checking its
    tables as the kernels read them; raises on what they cannot take."""
    dev = medium.device
    rows = medium.density_rows
    dense = rows is None
    if dense:
        _check_dense_arrays(medium, emission_enabled(medium, params), dev)
        maj = medium.majorants.rows
        if maj.dtype != torch.float32 or maj.dim() != 2 or maj.shape[1] != 2 or maj.device != dev \
                or not maj.is_contiguous() or maj.data_ptr() % 8:
            raise ValueError(f"majorants.rows must be a contiguous float32 [NB, 2] table on {dev}")
    elif rows.dtype != torch.float32 or not rows.is_contiguous() or rows.shape[1] not in (8, 16) \
            or rows.data_ptr() % 16 or rows.shape[0] >= 2**31:
        raise ValueError("density_rows must be a contiguous, 16-byte aligned "
                         "float32 [R < 2^31, 8 or 16] table")
    emission = 0
    if emission_enabled(medium, params):
        if bb_table is None:
            raise ValueError("an emissive medium needs the blackbody table")
        if dense:
            emission = 3
        else:
            emission = 1 if rows.shape[1] >= 16 else 2
        trows = medium.temperature_rows
        if emission == 2 and (trows is None or trows.device != dev or not trows.is_contiguous()
                              or trows.data_ptr() % 16 or trows.shape[0] >= 2**31):
            raise ValueError("an 8-wide emissive medium needs its temperature "
                             f"corner rows as a contiguous table on {dev}")
    return dense, emission


def _check_dense(data: torch.Tensor, shape, name: str, device, gradient: bool = False):
    """A dense array as the dense instantiations read it: the grid's own, of
    the grid's `shape` (the kernels index it by that shape, and the launch
    refuses an array of another length). The forward launches
    (render_wave_kernel, trace_lanes_kernel) take any voxel count: the fetch
    (dense_trilinear) makes each voxel's offset in 64 bits. The gradient
    launches (gradient=True: record_lanes, replay_lanes, whose replay adds
    into gradient grids of the same shape) take fewer than 2^31 voxels: no
    card test holds them past that yet."""
    if data.dtype != torch.float32 or data.dim() != 3 or data.device != device or not data.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 [X, Y, Z] tensor on {device}")
    if tuple(data.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(data.shape)}, its grid {tuple(shape)}")
    if gradient and data.numel() >= 2**31:
        raise ValueError(f"{name} has {data.numel()} voxels: a gradient launch takes dense arrays of "
                         f"fewer than 2^31 voxels")


def _check_dense_arrays(medium: Medium, emission: bool, device, gradient: bool = False):
    """_check_dense on the arrays a dense launch reads (dense_arrays)."""
    dens, tdata = dense_arrays(medium, emission)
    _check_dense(dens, medium.density.shape, "the density array", device, gradient)
    if tdata is not None:
        _check_dense(tdata, medium.temperature.shape, "the temperature array", device, gradient)


def dense_arrays(medium: Medium, emission: bool):
    """(density, temperature or None) arrays that a dense launch reads: the
    grids' own. `emission`: whether the launch reads the temperature."""
    return medium.density.data, (medium.temperature.data if emission else None)


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


SECTOR_FLOATS = 8  # a 32-byte sector of a dense array, the unit the dense tap marks


def tap_layout(medium: Medium, emission: int):
    """What a measuring launch marks in row_tap, in order, as (what, marks,
    bytes a mark stands for). `emission` is KernelConstants.emission. With
    the fused table: its rows, then the temperature corner rows if read.
    Without it: the 32-byte sectors of the density array as the launch
    reads it (dense_arrays), the majorant pairs, then the sectors of the
    temperature array if read."""
    rows = medium.density_rows
    if rows is not None:
        out = [("rows", rows.shape[0], rows.shape[1] * 4)]
        if emission == 2:
            out.append(("temperature rows", medium.temperature_rows.shape[0], 32))
        return out
    dens, tdata = dense_arrays(medium, emission == 3)
    out = [("density sectors", -(-dens.numel() // SECTOR_FLOATS), 32),
           ("majorant pairs", medium.majorants.rows.shape[0], 8)]
    if emission == 3:
        out.append(("temperature sectors", -(-tdata.numel() // SECTOR_FLOATS), 32))
    return out


def new_row_tap(medium: Medium, params: IntegratorParams, bb_table: Optional[torch.Tensor]) -> torch.Tensor:
    """A zeroed `row_tap` tensor for a measuring launch on this scene."""
    emission = kernel_constants(medium, params, bb_table).emission
    return torch.zeros(sum(n for _, n, _ in tap_layout(medium, emission)), dtype=torch.uint8,
                       device=medium.device)


def read_row_tap(medium: Medium, params: IntegratorParams, bb_table: Optional[torch.Tensor],
                 row_tap: torch.Tensor):
    """[(what, marks set, marks in all, bytes the set marks stand for)] of a
    tap a measuring launch filled."""
    emission = kernel_constants(medium, params, bb_table).emission
    out, at = [], 0
    for what, n, nbytes in tap_layout(medium, emission):
        hit = int(row_tap[at:at + n].sum())
        out.append((what, hit, n, hit * nbytes))
        at += n
    return out


def _table_args(medium: Medium, consts: KernelConstants, dev, row_tap, stat):
    """The arguments both launches end with (rows .. stat), checked."""
    lib = _library()
    if consts.fp.size != lib.vpt_num_fparams() or consts.ip.size != lib.vpt_num_iparams():
        raise RuntimeError("kernel parameter layout mismatch with csrc/trace_lanes.cu")
    if medium.device != dev:
        raise ValueError(f"the medium lives on {medium.device}, the lanes on {dev}")
    if stat is not None and row_tap is None:
        raise ValueError("stat is filled by the measuring launch: pass row_tap too")
    if row_tap is not None:
        _check(row_tap, "row_tap", torch.uint8,
               (sum(n for _, n, _ in tap_layout(medium, consts.emission)),), dev)
    if stat is not None:
        _check(stat, "stat", torch.int64, (stat_size(dev),), dev)
    if consts.dense:
        (dens, tdata), maj = dense_arrays(medium, consts.emission == 3), medium.majorants.rows
        tables = (None, 0, 0, None, 0, _ptr(consts.pairs), dens.data_ptr(), dens.numel(),
                  maj.data_ptr(), maj.shape[0], _ptr(tdata), tdata.numel() if tdata is not None else 0)
    else:
        rows = medium.density_rows
        trows = medium.temperature_rows if consts.emission == 2 else None
        tables = (rows.data_ptr(), rows.shape[0], rows.shape[1], _ptr(trows),
                  trows.shape[0] if trows is not None else 0, _ptr(consts.pairs),
                  None, 0, None, 0, None, 0)
    return (*tables, consts.fp.ctypes.data, consts.ip.ctypes.data,
            consts.scratch.data_ptr(), _ptr(row_tap), _ptr(stat))


def trace_lanes(
    medium: Medium, params: IntegratorParams, bb_table: Optional[torch.Tensor],
    sf: torch.Tensor, si: torch.Tensor, pixel_ids: torch.Tensor, streams: torch.Tensor,
    max_steps: int, row_tap: Optional[torch.Tensor] = None,
    stat: Optional[torch.Tensor] = None, return_lane_iters: bool = False,
):
    """Advance every lane until DONE or `max_steps` steps; returns new (sf, si).

    sf [21, N] float32 and si [3, N] int32 are the SoA state (STATE_F32,
    STATE_I32), pixel_ids and streams [N] integer (uint32 values). On CUDA
    tensors this launches trace_lanes_kernel once, or raises; on CPU tensors
    it runs trace_lanes_plain. The kernel works in place; the state is
    cloned first only because this contract returns new tensors and leaves
    its arguments as they were. For measurement (CUDA only): row_tap, a
    zeroed new_row_tap tensor in which the launch marks what it reads of the
    medium (tap_layout), and with it stat, a zeroed launch_stat tensor.

    return_lane_iters=True appends this call's lane-iterations (0-d int64):
    each lane's steps in the call, less one for a lane the call retired
    (integrator.lane_iterations), from the counters and modes in and out.
    """
    out = _trace_lanes(medium, params, bb_table, sf, si, pixel_ids, streams, max_steps, row_tap, stat)
    if not return_lane_iters:
        return out
    si_out = out[1]
    retired = ((si[1] != DONE) & (si_out[1] == DONE)).sum()
    return (*out, (si_out[2].to(torch.int64) - si[2].to(torch.int64)).sum() - retired)


def _trace_lanes(medium, params, bb_table, sf, si, pixel_ids, streams, max_steps, row_tap, stat):
    if sf.device.type == "cpu":
        return trace_lanes_plain(medium, params, bb_table, sf, si, pixel_ids, streams, max_steps)
    if sf.device.type != "cuda":
        raise ValueError(f"trace_lanes: unsupported device {sf.device}")
    dev = sf.device
    n = sf.shape[1]
    _check(sf, "sf", torch.float32, (len(STATE_F32), n), dev)
    _check(si, "si", torch.int32, (len(STATE_I32), n), dev)
    consts = kernel_constants(medium, params, bb_table)
    tables = _table_args(medium, consts, dev, row_tap, stat)
    pids = _as_i32_bits(pixel_ids.to(dev))
    strm = _as_i32_bits(streams.to(dev))
    _check(pids, "pixel_ids", torch.int32, (n,), dev)
    _check(strm, "streams", torch.int32, (n,), dev)
    sf = sf.clone()
    si = si.clone()
    err = _library().vpt_trace_lanes(
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
        sf.data_ptr(), si.data_ptr(), pids.data_ptr(), strm.data_ptr(), n, int(max_steps), *tables,
    )
    _raise_on(err, "trace_lanes launch")
    global LAUNCHES, DENSE_LAUNCHES
    LAUNCHES += 1
    DENSE_LAUNCHES += consts.dense
    return sf, si


def render_wave(
    medium: Medium, params: IntegratorParams, camera: Camera, bb_table: Optional[torch.Tensor],
    film: torch.Tensor, pixels: Pixels, stream: int, use_jitter: bool, imaging_ratio: float,
    max_iters: Optional[int] = None, row_tap: Optional[torch.Tensor] = None,
    stat: Optional[torch.Tensor] = None, return_lane_iters: bool = False,
):
    """One sample of each of `pixels`, added to `film` in place.

    film: [H, W, 4] float32, contiguous (XYZ sum, sample count). pixels: a
    contiguous range of global pixel ids (y * W + x), or an integer tensor
    of them; A PIXEL ID MAY OCCUR ONCE, since each lane adds its sample
    with a plain read and write: film[pid] += (imaging_ratio * L, 1). stream:
    the wave's uint32 stream word (utils.rng.mix_stream(seed, wave)); the
    jitter is drawn on (pid, stream, JITTER_COUNTER), the steps on (pid,
    stream, lane counter), so the result does not depend on how pixels are
    split over launches or threads. A lane stopped by the cap (max_iters,
    default params.max_iters) adds what it gathered and no infinite light.

    Returns (iterations, n_capped) as 0-d int32 tensors: the largest lane
    counter and the lanes stopped by the cap. return_lane_iters=True appends
    the wave's lane-iterations as a 0-d int64 tensor
    (integrator.lane_iterations: on the card the kernel's own count, taken
    by its counting instantiation, which a measuring launch cannot be). No
    host synchronisation.

    On CUDA tensors this launches render_wave_kernel once, or raises; on CPU
    tensors it runs render_wave_plain. row_tap and stat: as in trace_lanes.
    """
    if film.device.type == "cpu":
        return render_wave_plain(medium, params, camera, bb_table, film, pixels, stream,
                                 use_jitter, imaging_ratio, max_iters, return_lane_iters)
    if film.device.type != "cuda":
        raise ValueError(f"render_wave: unsupported device {film.device}")
    if return_lane_iters and row_tap is not None:
        raise ValueError("render_wave: a measuring launch (row_tap) does not count lane-iterations")
    dev = film.device
    if film.dim() != 3 or film.shape[2] != 4:
        raise ValueError(f"film: expected [H, W, 4], got {tuple(film.shape)}")
    _check(film, "film", torch.float32, film.shape, dev)
    n_pixels = film.shape[0] * film.shape[1]
    if n_pixels >= 2**31:
        raise ValueError("the film has too many pixels for 32-bit pixel ids")
    if isinstance(pixels, range):
        if pixels.step != 1 or pixels.start < 0 or pixels.stop > n_pixels:
            raise ValueError(f"pixels: {pixels} is not a contiguous range of the film's pixels")
        pids, start, n = None, pixels.start, len(pixels)
    else:
        # The ids themselves stay unread here: a read would wait for the device.
        pids = pixels
        _check(pids, "pixels", torch.int32, (pids.shape[0],), dev)
        start, n = 0, pids.shape[0]
    with span("render.launch"):
        consts = kernel_constants(medium, params, bb_table, camera, film.shape[1], use_jitter,
                                  imaging_ratio)
        tables = _table_args(medium, consts, dev, row_tap, stat)
        steps = params.max_iters if max_iters is None else max_iters
        launch = _library().vpt_render_wave_counted if return_lane_iters else _library().vpt_render_wave
        err = launch(
            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
            film.data_ptr(), _ptr(pids), start, n, int(stream) & 0xFFFFFFFF, int(steps), *tables,
        )
        _raise_on(err, "render_wave launch")
        global WAVE_LAUNCHES, DENSE_WAVE_LAUNCHES
        WAVE_LAUNCHES += 1
        DENSE_WAVE_LAUNCHES += consts.dense
        # The scratch belongs to the next launch too: hand out a copy.
        if return_lane_iters:
            out = consts.scratch.clone()
            return out[2], out[1], out[4:6].view(torch.int64)[0]
        out = consts.scratch[1:3].clone()
        return out[1], out[0]


# --------------------------------------------------------- gradient path ----

def _stream_bits(stream, n: int, dev) -> torch.Tensor:
    """The per-lane stream words (integrator.lane_streams) as int32 bits
    [n] on `dev`: an int32 tensor as it is (loss_rays' words on the card),
    else in one launch: an int64 tensor's low words (CUDA memory is
    little-endian), or one word filled."""
    if isinstance(stream, int):
        word = stream & 0xFFFFFFFF
        return torch.full((n,), word - (word >> 31 << 32), dtype=torch.int32, device=dev)
    if isinstance(stream, torch.Tensor) and tuple(stream.shape) == (n,):
        stream = stream.to(dev)
        if stream.dtype == torch.int64:
            return stream.contiguous().view(torch.int32)[0::2].contiguous()
        if stream.dtype == torch.int32:
            return stream.contiguous()
    return _as_i32_bits(lane_streams(stream, n, dev))


def _ray_args(what: str, medium: Medium, params: IntegratorParams, bb_table, o_world, d_world, pixel_ids,
              stream, row_tap, stat):
    """What a gradient-path launch takes of a ray batch on a CUDA device,
    checked: (device, n, the origins' row stride, the scene's constants,
    pixel ids and streams as int32 bits, the table arguments). The kernels
    make each lane's initial state from its ray themselves."""
    if o_world.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {o_world.device}")
    dev = o_world.device
    n = d_world.shape[0]
    _check(d_world, "d_world", torch.float32, (n, 3), dev)
    if o_world.dtype != torch.float32 or tuple(o_world.shape) != (n, 3) or o_world.device != dev \
            or o_world.stride() not in ((3, 1), (0, 1)):
        raise ValueError(f"o_world: expected float32 ({n}, 3) on {dev}, contiguous or one origin "
                         f"expanded over the rays, got {o_world.dtype} {tuple(o_world.shape)} strides "
                         f"{o_world.stride()} on {o_world.device}")
    consts = kernel_constants(medium, params, bb_table)
    if consts.dense:
        _check_dense_arrays(medium, consts.emission == 3, dev, gradient=True)
    pids = pixel_ids.to(dev)
    pids = pids.contiguous() if pids.dtype == torch.int32 else _as_i32_bits(pids)
    _check(pids, "pixel_ids", torch.int32, (n,), dev)
    strm = _stream_bits(stream, n, dev)
    return dev, n, o_world.stride(0), consts, pids, strm, _table_args(medium, consts, dev, row_tap, stat)


def record_lanes_plain(medium: Medium, params: IntegratorParams, bb_table: Optional[torch.Tensor],
                       o_world: torch.Tensor, d_world: torch.Tensor, pixel_ids: torch.Tensor, stream,
                       k_walks: int):
    """record_lanes's plain version: diff/prb.py _trace_rays_record's loop;
    the counters are its final state's."""
    global PLAIN_RECORD_LAUNCHES
    PLAIN_RECORD_LAUNCHES += 1
    st, tf = record_state(medium, params, bb_table, o_world, d_world, pixel_ids, stream, k_walks)
    return finalize_radiance(st, params), tf, st.ctr


def record_lanes(
    medium: Medium, params: IntegratorParams, bb_table: Optional[torch.Tensor],
    o_world: torch.Tensor, d_world: torch.Tensor, pixel_ids: torch.Tensor, stream, k_walks: int,
    row_tap: Optional[torch.Tensor] = None, stat: Optional[torch.Tensor] = None,
):
    """The forward of the gradient path: (radiance [N, 3], tf [N, k_walks],
    ctr [N] int32), where tf holds each lane's NEE walk residuals (diff/
    prb.py _trace_rays_record's encoding) and ctr each lane's last draw
    counter (what orders the replay's queue, longest_first), up to
    params.max_iters steps a lane.

    o_world [N, 3] (contiguous, or one origin expanded over the rays, as
    Camera.generate_rays gives it) and d_world [N, 3] float32; pixel_ids [N]
    and stream (one word or [N]) as for trace_rays. On CUDA tensors this
    launches the record instantiation of trace_lanes_kernel once, or raises:
    each lane is born in the kernel from its ray as init_state makes it,
    runs trace_lanes's lane step and ends as its three outputs; every slot
    of tf is written. The kernel's world -> index is a true division, as
    init_state's (grids/grid.py), so the radiance and counters are
    trace_rays_fused's bit for bit. On CPU tensors it runs
    record_lanes_plain. With residuals to record (k_walks > 0) it refuses
    max_iters >= 2^24, where a counter would not be exact as a float32.
    row_tap and stat: as in trace_lanes.
    """
    if o_world.device.type == "cpu":
        return record_lanes_plain(medium, params, bb_table, o_world, d_world, pixel_ids, stream, k_walks)
    if k_walks > 0 and params.max_iters >= MAX_RECORD_ITERS:
        raise ValueError(f"max_iters {params.max_iters} >= 2^24: counters would not be exact residuals")
    if k_walks < 0:
        raise ValueError(f"k_walks must be >= 0, got {k_walks}")
    dev, n, o_stride, consts, pids, strm, tables = _ray_args("record_lanes", medium, params, bb_table, o_world,
                                                             d_world, pixel_ids, stream, row_tap, stat)
    L = torch.empty((n, 3), dtype=torch.float32, device=dev)
    ctr = torch.empty((n,), dtype=torch.int32, device=dev)
    tf = torch.empty((n, k_walks), dtype=torch.float32, device=dev)
    err = _library().vpt_record_lanes(
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream, o_world.data_ptr(), o_stride,
        d_world.data_ptr(), pids.data_ptr(), strm.data_ptr(), n, int(params.max_iters), L.data_ptr(),
        ctr.data_ptr(), tf.data_ptr(), int(k_walks), *tables,
    )
    _raise_on(err, "record_lanes launch")
    global RECORD_LAUNCHES, DENSE_RECORD_LAUNCHES
    RECORD_LAUNCHES += 1
    DENSE_RECORD_LAUNCHES += consts.dense
    return L, tf, ctr


# Lanes a queue group holds (longest_first).
QUEUE_GROUP = 1024


def longest_first(ctr: torch.Tensor, group: int = QUEUE_GROUP) -> torch.Tensor:
    """The replay's queue order from the record's counters, as int32 [N]:
    groups of `group` consecutive lanes, the group with the longest lane
    first, and the lanes of a group in index order. Consecutive lanes are
    neighbouring pixels of one sample wave, whose rays read neighbouring
    rows: a warp that takes them together gathers and adds coherently,
    while a sort of the lanes themselves scatters every warp over the image
    (measured: PERF.md, Findings). On the device, no host
    synchronisation."""
    n = ctr.shape[0]
    top = F.pad(ctr, (0, (-n) % group)).view(-1, group).amax(1)
    key = top.repeat_interleave(group)[:n]
    return torch.argsort(key, descending=True, stable=True).to(torch.int32)


def replay_lanes_plain(medium: Medium, params: IntegratorParams, bb_table: Optional[torch.Tensor],
                       o_world, d_world, pixel_ids, stream, L_fwd, g_vec, tf=None, with_check=False,
                       order=None):
    """replay_lanes's plain version: diff/prb.py replay_grads. With an
    order, the lanes go in permuted by it and the per-lane results come out
    in the lanes' own order (the gradient grids sum in another order)."""
    global PLAIN_REPLAY_LAUNCHES
    PLAIN_REPLAY_LAUNCHES += 1
    if order is None:
        return replay_grads(medium, params, bb_table, o_world, d_world, pixel_ids, stream, L_fwd, g_vec,
                            with_check=with_check, tf=tf)
    idx = order.to(torch.int64)
    n = idx.shape[0]

    def permuted(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == n:
            return x.index_select(0, idx)
        return x

    out = replay_grads(medium, params, bb_table, *map(permuted, (o_world, d_world, pixel_ids, stream, L_fwd,
                                                                 g_vec)), with_check=with_check, tf=permuted(tf))
    if not with_check:
        return out
    d_density, d_temp, acc_p, tot_p = out
    acc, tot = torch.empty_like(acc_p), torch.empty_like(tot_p)
    acc[idx], tot[idx] = acc_p, tot_p
    return d_density, d_temp, acc, tot


def replay_lanes(
    medium: Medium, params: IntegratorParams, bb_table: Optional[torch.Tensor],
    o_world: torch.Tensor, d_world: torch.Tensor, pixel_ids: torch.Tensor, stream,
    L_fwd: torch.Tensor, g_vec: torch.Tensor, tf: Optional[torch.Tensor] = None,
    with_check: bool = False, lane_steps: Optional[torch.Tensor] = None,
    order: Optional[torch.Tensor] = None,
    row_tap: Optional[torch.Tensor] = None, stat: Optional[torch.Tensor] = None,
):
    """The backward of the gradient path: (d_density [X, Y, Z],
    d_temperature or None), with diff/prb.py replay_grads's contract (and
    its (gL_acc, gL_tot) when with_check). The rays, ids and stream are the
    record's (record_lanes).

    On CUDA tensors this launches replay_lanes_kernel once (or raises): one
    thread replays one lane, born from its ray as the record's was, refilled
    from a queue that takes the lanes in `order` (an int32 [N] permutation,
    longest_first of the record's counters; None: index order), and adds
    each event's 8 weighted corners straight into the gradient grids it
    returns (zeroed here, the medium's density shape and, with emission,
    its temperature shape) with float atomics, dropping the corners outside
    the grid: no corner-row table and no fold. Each lane's replay is the
    same whatever the order; atomics add in another order on every run, so
    the gradients equal the plain version's to float tolerance, not bitwise.
    For measurement (CUDA only): lane_steps, with with_check, an int32 [N]
    tensor that gets each lane's replay steps; row_tap and stat as in
    trace_lanes. On CPU tensors this runs replay_lanes_plain.
    """
    if o_world.device.type == "cpu":
        return replay_lanes_plain(medium, params, bb_table, o_world, d_world, pixel_ids, stream, L_fwd,
                                  g_vec, tf=tf, with_check=with_check, order=order)
    dev, n, o_stride, consts, pids, strm, tables = _ray_args("replay_lanes", medium, params, bb_table, o_world,
                                                             d_world, pixel_ids, stream, row_tap, stat)
    g_vec = g_vec.to(torch.float32).contiguous()
    L_fwd = L_fwd.to(torch.float32).contiguous()
    _check(g_vec, "g_vec", torch.float32, (n, 3), dev)
    _check(L_fwd, "L_fwd", torch.float32, (n, 3), dev)
    k_walks = 0
    if tf is not None:
        k_walks = tf.shape[1]
        _check(tf, "tf", torch.float32, (n, k_walks), dev)
    if order is not None:
        _check(order, "order", torch.int32, (n,), dev)
    d_density = torch.zeros(medium.density.shape, dtype=torch.float32, device=dev)
    d_temp = None
    if consts.emission:
        d_temp = torch.zeros(medium.temperature.shape, dtype=torch.float32, device=dev)
    gacc = steps = None
    if with_check:
        gacc = torch.zeros((n,), dtype=torch.float32, device=dev)
        steps = lane_steps if lane_steps is not None else torch.zeros((n,), dtype=torch.int32, device=dev)
        _check(steps, "lane_steps", torch.int32, (n,), dev)
    err = _library().vpt_replay_lanes(
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream, o_world.data_ptr(), o_stride,
        d_world.data_ptr(), pids.data_ptr(), strm.data_ptr(), _ptr(order), n, replay_iteration_cap(params),
        int(params.max_iters), _ptr(tf), k_walks, g_vec.data_ptr(), L_fwd.data_ptr(), d_density.data_ptr(),
        _ptr(d_temp), _ptr(gacc), _ptr(steps), *tables,
    )
    _raise_on(err, "replay_lanes launch")
    global REPLAY_LAUNCHES, DENSE_REPLAY_LAUNCHES
    REPLAY_LAUNCHES += 1
    DENSE_REPLAY_LAUNCHES += consts.dense
    if with_check:
        return d_density, d_temp, gacc, dot3(g_vec, L_fwd)
    return d_density, d_temp


# ------------------------------------------------------------ train step ----

def loss_rays_plain(camera: Camera, raster: torch.Tensor, pids: torch.Tensor, seed_wave, k: int,
                    use_jitter: bool):
    """loss_rays's plain version, in torch: the k stream words made on the
    host and copied over, the jitter draws (utils.rng.counter_uniforms),
    Camera.generate_rays. stream_k is int64 (uint32 values)."""
    global PLAIN_LOSS_RAYS_LAUNCHES
    PLAIN_LOSS_RAYS_LAUNCHES += 1
    n = pids.shape[0]
    seed, wave0 = int(seed_wave[0]), int(seed_wave[1])
    streams = [vrng.mix_stream(seed, (wave0 * k + i) & 0xFFFFFFFF) for i in range(k)]
    stream_k = torch.tensor(streams, dtype=torch.int64, device=pids.device).repeat_interleave(n)
    pids_k = pids.repeat(k)
    u_jit = vrng.counter_uniforms(pids_k, stream_k, JITTER_COUNTER, 2)
    o_w, d_w = camera.generate_rays(raster.repeat(k, 1), u_jit * (0.5 if use_jitter else 0.0))
    return o_w, d_w, pids_k, stream_k


def loss_rays(camera: Camera, raster: torch.Tensor, pids: torch.Tensor, seed_wave, k: int, use_jitter: bool,
              jitter_out: Optional[torch.Tensor] = None):
    """The ray batch of one loss evaluation: k waves of the pixel batch,
    wave seed_wave[1] * k + i of seed seed_wave[0] for i < k, as one flat
    batch (o_world, d_world [k * N, 3], pixel ids [k * N] of pids' type,
    per-lane stream words [k * N]). raster [N, 2] and pids [N] are integer;
    seed_wave holds two Python ints, or is an int32 [2] tensor of their
    uint32 bits on pids' device, which the kernel reads when it runs (what
    a CUDA graph of the call replays with new words). o_world is the
    camera's position expanded over the lanes (stride 0).

    On CUDA tensors (int32 or int64 raster and pids) this launches
    loss_rays_kernel once, or raises: nothing is copied from the host and
    nothing waits for the card. The stream words are then int32 bits, which
    every consumer reads as its uint32 word (lane_streams, _stream_bits),
    and the directions equal the plain version's to rounding (the sum's
    order). jitter_out, CUDA only: a float32 [k * N, 2] tensor that gets each
    lane's two jitter uniforms (for checks). On CPU tensors this runs
    loss_rays_plain, and a jitter_out raises.
    """
    if pids.device.type == "cpu":
        if jitter_out is not None:
            raise ValueError("loss_rays: jitter_out is filled on CUDA tensors only")
        return loss_rays_plain(camera, raster, pids, seed_wave, k, use_jitter)
    if pids.device.type != "cuda":
        raise ValueError(f"loss_rays: unsupported device {pids.device}")
    dev = pids.device
    n = pids.shape[0]
    lanes = k * n
    if k < 0 or lanes >= 2**31:
        raise ValueError(f"loss_rays: {k} x {n} lanes do not fit 32-bit lane indices")
    ints = (torch.int32, torch.int64)
    raster, pids = raster.contiguous(), pids.contiguous()
    if raster.dtype not in ints or pids.dtype not in ints:
        raise ValueError(f"loss_rays: raster and pids must be int32 or int64, got {raster.dtype}, {pids.dtype}")
    _check(raster, "raster", raster.dtype, (n, 2), dev)
    _check(pids, "pids", pids.dtype, (n,), dev)
    m, t = camera.raster_to_world_dir, camera.raster_to_world_trans
    _check(m, "raster_to_world_dir", torch.float32, (3, 3), dev)
    _check(t, "raster_to_world_trans", torch.float32, (3,), dev)
    if jitter_out is not None:
        _check(jitter_out, "jitter_out", torch.float32, (lanes, 2), dev)
    if isinstance(seed_wave, torch.Tensor):
        _check(seed_wave, "seed_wave", torch.int32, (2,), dev)
        seed, wave0, sw = 0, 0, seed_wave
    else:
        seed, wave0, sw = int(seed_wave[0]) & 0xFFFFFFFF, int(seed_wave[1]) & 0xFFFFFFFF, None
    d_w = torch.empty((lanes, 3), dtype=torch.float32, device=dev)
    pids_k = torch.empty((lanes,), dtype=pids.dtype, device=dev)
    stream_k = torch.empty((lanes,), dtype=torch.int32, device=dev)
    err = _library().vpt_loss_rays(
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream, raster.data_ptr(),
        int(raster.dtype == torch.int64), pids.data_ptr(), int(pids.dtype == torch.int64), m.data_ptr(),
        t.data_ptr(), seed, wave0, _ptr(sw), k, n, int(bool(use_jitter)),
        d_w.data_ptr(), pids_k.data_ptr(), stream_k.data_ptr(), _ptr(jitter_out),
    )
    _raise_on(err, "loss_rays launch")
    global LOSS_RAYS_LAUNCHES
    LOSS_RAYS_LAUNCHES += 1
    return camera.position.expand(lanes, 3), d_w, pids_k, stream_k


# --------------------------------------------------------- measurement ----

def simt_efficiency(steps: torch.Tensor, group: int = 32) -> float:
    """SIMT efficiency of running one lane per thread with no refill: the
    lane-steps taken over the thread-steps issued, when every group of
    `group` consecutive lanes runs as long as its longest lane.

    steps: [N] integer, the steps each lane took (its counter, for a batch
    that started at 0). N is padded with idle lanes to a multiple of `group`.
    """
    c = steps.to(torch.int64).reshape(-1)
    pad = (-c.shape[0]) % group
    if pad:
        c = torch.cat([c, c.new_zeros(pad)])
    issued = group * int(c.view(-1, group).max(dim=1).values.sum())
    return float(c.sum()) / issued if issued else 1.0


def stat_size(device: torch.device) -> int:
    """Length of a launch_stat tensor: two counters, then two clock readings
    for each warp the card can hold resident at all (whatever a kernel's
    registers allow, so every instantiation of every source fits)."""
    props = torch.cuda.get_device_properties(device)
    per_sm = getattr(props, "max_threads_per_multi_processor", 2048)
    return 2 + 2 * props.multi_processor_count * per_sm // 32


def launch_stat(device: torch.device) -> torch.Tensor:
    """A zeroed tensor for the `stat` argument of any launch."""
    return torch.zeros(stat_size(device), dtype=torch.int64, device=device)


def read_launch_stat(stat: torch.Tensor) -> dict:
    """What a measuring launch wrote into `stat`:

    warp_steps, lane_steps: loop rounds in which a warp stepped, summed over
    warps, and the thread-steps among them that advanced a lane;
    simt_efficiency = lane_steps / (32 * warp_steps), as issued;
    warps: warps that ran; span_ns: first warp start to last warp end, on
    the device's global timer; half_idle_share: the share of that span
    during which fewer than half of the warps still had work (the time from
    the median warp's end to the last warp's end).
    """
    s = stat.cpu().numpy()
    warp_steps, lane_steps = int(s[0]), int(s[1])
    clocks = s[2:].reshape(-1, 2)
    clocks = clocks[clocks[:, 1] != 0]
    out = {
        "warp_steps": warp_steps, "lane_steps": lane_steps,
        "simt_efficiency": lane_steps / (32 * warp_steps) if warp_steps else 1.0,
        "warps": int(clocks.shape[0]), "span_ns": 0, "half_idle_share": 0.0,
    }
    if clocks.shape[0]:
        t0, t1 = int(clocks[:, 0].min()), int(clocks[:, 1].max())
        ends = np.sort(clocks[:, 1])
        half = int(ends[(ends.shape[0] - 1) // 2])  # from here on, under half the warps work
        out["span_ns"] = t1 - t0
        out["half_idle_share"] = (t1 - half) / (t1 - t0) if t1 > t0 else 0.0
    return out


# -------------------------------------------------------------- tracer ----

def trace_rays_fused(
    medium: Medium,
    params: IntegratorParams,
    bb_table: Optional[torch.Tensor],
    o_world: torch.Tensor,
    d_world: torch.Tensor,
    pixel_ids: torch.Tensor,
    stream,
    return_lane_iters: bool = False,
):
    """Forward render of a ray batch through trace_lanes; same contract as
    integrator.trace_rays: (radiance [N, 3], iterations, n_capped[,
    lane_iterations]), the counts as 0-d tensors (iterations = the largest
    lane counter). No host synchronisation."""
    st0 = init_state(medium, o_world, d_world, params)
    sf, si = pack_state(st0)
    n = sf.shape[1]
    streams = lane_streams(stream, n, sf.device)
    sf, si, *lane_it = trace_lanes(medium, params, bb_table, sf, si, pixel_ids, streams, params.max_iters,
                                   return_lane_iters=return_lane_iters)
    L = sf[10:13].T
    if n == 0:
        zero = torch.zeros((), dtype=torch.int64, device=sf.device)
        return (L, zero, zero, *lane_it)
    return (L, si[2].max().to(torch.int64), (si[1] != DONE).sum(), *lane_it)
