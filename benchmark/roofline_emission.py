"""The gradient kernels' roofline bounds on an emissive medium: roofline.py's
record and replay bounds plus what emission adds to them, counted, as there,
from the cell's inputs and the reference's walk of the first step's seeded
batch, never from the program's counters.

At each camera-path real collision the record kernel reads the temperature's
8 corners through the temperature grid's own transform and the blackbody
pairs, and adds p_a * le * B(T); the replay does the same and then the
emission's two derivatives, and adds the temperature corners' gradient into
their rows. So, over roofline.record and roofline.replay:
  - bytes: 32 B a distinct temperature corner set read (the record), read
    and its gradient row written (the replay), as the density's corners;
  - operations: OPS_PER_EMISSION a camera-path real collision in the record,
    OPS_PER_EMISSION_GRAD in the replay.
"""
from __future__ import annotations

from typing import NamedTuple

from . import roofline

# the temperature's transform (6), its trilinear weights and dot (31), the
# blackbody slot and lerp (12), the emission added (7)
OPS_PER_EMISSION = 56
# the same, plus <g, B>, <g, B'> (10), the density term (4), the temperature
# term (5) and its 8 weighted corners (8)
OPS_PER_EMISSION_GRAD = OPS_PER_EMISSION + 27


class Work(NamedTuple):
    """roofline.Work's fields, in its order, and the emission's count."""
    lanes: int
    lane_steps: float
    corners: int
    pairs: int
    tcorners: int  # distinct temperature corner sets read
    emissive: float  # camera-path real collisions (each one emits)


def _more(base: roofline.Bound, ops: float, nbytes: float) -> roofline.Bound:
    return roofline._bound(base.ops + ops, base.bytes + nbytes)


def record(w: Work) -> roofline.Bound:
    return _more(roofline.record(w), w.emissive * OPS_PER_EMISSION, w.tcorners * roofline.CORNER_BYTES)


def replay(w: Work) -> roofline.Bound:
    return _more(roofline.replay(w), w.emissive * OPS_PER_EMISSION_GRAD, 2 * w.tcorners * roofline.CORNER_BYTES)
