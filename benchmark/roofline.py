"""The yardstick's peaks and the work of each kernel, counted from the
cell's inputs and the reference's walk, never from the program's counters.

A kernel's roofline time is the larger of its operations over the fp32 peak
outside the tensor cores and its bytes over the HBM bandwidth, each input
counted once. Lane-steps come from the reference's walk of a seeded sample
of the launch's lanes, scaled to all of its lanes; the voxels and majorant
pairs a launch needs are the distinct ones that sample reads, a lower bound
of the whole launch's (so the bound, and the share, never read high).
"""
from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

OPS_PER_FORWARD_STEP = 150  # one tracking event: draws, free flight, trilinear sample, event, scatter
OPS_PER_REPLAY_STEP = 200  # the same step walked again, plus its derivative terms
OPS_PER_RAY = 80  # a lane's birth (jitter, camera ray, world -> index, box clip) and its end

CORNER_BYTES = 32  # the 8 corners of a trilinear sample, float32
PAIR_BYTES = 8  # a brick's (brick, superbrick) majorant pair
FILM_PIXEL_BYTES = 16  # (X, Y, Z, weight) float32
RAY_BYTES = 24 + 8  # a world ray (origin, direction) plus its pixel id and stream word


class Work(NamedTuple):
    """What one launch has to do."""
    lanes: int
    lane_steps: float
    corners: int  # distinct density samples' corner sets read
    pairs: int  # distinct majorant pairs read
    tcorners: int = 0  # distinct temperature corner sets read


class Bound(NamedTuple):
    seconds: float
    binds: str  # "operations" or "bytes"
    ops: float
    bytes: float


def _bound(ops: float, nbytes: float) -> Bound:
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S
    return Bound(max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def wave(w: Work) -> Bound:
    """render_wave_kernel: every lane born from its pixel, walked, and added
    to the film (each film pixel read and written once)."""
    ops = w.lane_steps * OPS_PER_FORWARD_STEP + w.lanes * OPS_PER_RAY
    nbytes = 2 * w.lanes * FILM_PIXEL_BYTES + (w.corners + w.tcorners) * CORNER_BYTES + w.pairs * PAIR_BYTES
    return _bound(ops, nbytes)


def record(w: Work) -> Bound:
    """The record kernel: rays in, radiance (12 B) and last counter (4 B) out."""
    ops = w.lane_steps * OPS_PER_FORWARD_STEP + w.lanes * OPS_PER_RAY
    nbytes = w.lanes * (RAY_BYTES + 16) + w.corners * CORNER_BYTES + w.pairs * PAIR_BYTES
    return _bound(ops, nbytes)


def replay(w: Work) -> Bound:
    """The replay kernel: rays, cotangent and radiance in (24 B), the walk's
    voxels read and their gradient corners written."""
    ops = w.lane_steps * OPS_PER_REPLAY_STEP + w.lanes * OPS_PER_RAY
    nbytes = w.lanes * (RAY_BYTES + 24) + 2 * w.corners * CORNER_BYTES + w.pairs * PAIR_BYTES
    return _bound(ops, nbytes)


def share_percent(bound: Bound, launches: int, kernel_seconds: float):
    """100 * (launches * bound) / the launches' measured seconds, or None."""
    if launches <= 0 or kernel_seconds <= 0.0:
        return None
    return 100.0 * launches * bound.seconds / kernel_seconds
