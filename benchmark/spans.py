"""What the benchmark reads of the port's own spans in a traced window.

The port records spans at its layer boundaries while a profiler runs
(volume_path_tracer_tpu_torch/utils/spans.py): the wave (render.wave, or
shard.wave on a mesh), the train step (train.step) and the step's phases.
They share the profiler's clock with the CUPTI records that profiling.Trace
keeps, so the device's idle time can be put down to the span the host was
in. A unit is a top span (a wave or a step) that starts inside the window;
idle time is a device's time in the window outside its merged records, as
profiling.busy_s merges them, averaged over the cell's cards. A program
without the spans (one before them) gives no unit, and every reader then
returns None.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import profiling

WAVES = ("shard.wave", "render.wave")  # a mesh's wave holds its cells' launches, not render.wave
STEP = "train.step"
# the step's phases on the calling thread: disjoint, each inside its step
PHASES = {"rebuild": "train.rebuild", "rays": "train.rays", "record": "prb.record",
          "backward": "train.backward", "optimizer": "train.optimizer"}
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")

Interval = Tuple[float, float]


def named(tr: profiling.Trace, name: str) -> List[Interval]:
    """(start, end) of every host span or op called `name`, by start."""
    return sorted((s, e) for n, s, e in tr.cpu if n == name)


def units(tr: profiling.Trace, name: str) -> List[Interval]:
    """The spans called `name` that start inside the window."""
    return [iv for iv in named(tr, name) if tr.t0 <= iv[0] <= tr.t1]


def wave_units(tr: profiling.Trace) -> List[Interval]:
    """The window's waves: shard.wave spans on a mesh, else render.wave."""
    for name in WAVES:
        found = units(tr, name)
        if found:
            return found
    return []


def inside(spans: Sequence[Interval], outer: Sequence[Interval]) -> List[Interval]:
    """The spans that start inside one of `outer` (sorted, disjoint)."""
    if not outer:
        return []
    if not spans:
        return []
    ends = np.array([o[1] for o in outer])
    s = np.array([iv[0] for iv in spans])
    k = np.searchsorted(np.array([o[0] for o in outer]), s, side="right") - 1
    ok = (k >= 0) & (s <= ends[np.maximum(k, 0)])
    return [iv for iv, y in zip(spans, ok) if y]


def count_inside(tr: profiling.Trace, names: Sequence[str], outer: Sequence[Interval]) -> int:
    """Host records (ops, runtime calls) called one of `names` that start inside one of `outer`."""
    starts = [(s, s) for n, s, _ in tr.cpu if n in names]
    return len(inside(sorted(starts), outer))


def _busy(tr: profiling.Trace, device: int) -> List[List[float]]:
    return profiling._merged([(max(s, tr.t0), min(e, tr.t1)) for d, _, s, e in tr.device
                              if d == device and min(e, tr.t1) > max(s, tr.t0)])


def _busy_before(ivs: List[List[float]], t: np.ndarray) -> np.ndarray:
    """Busy time of the merged intervals `ivs` before each time in `t`."""
    bs = np.array([s for s, _ in ivs])
    be = np.array([e for _, e in ivs])
    cum = np.concatenate([[0.0], np.cumsum(be - bs)])
    k = np.searchsorted(bs, t, side="right") - 1
    kk = np.maximum(k, 0)
    return np.where(k >= 0, cum[kk] + np.clip(t - bs[kk], 0.0, be[kk] - bs[kk]), 0.0)


def idle_s(tr: profiling.Trace, spans: Sequence[Interval], devices) -> Optional[float]:
    """Seconds of the window inside `spans` in which the device ran nothing,
    averaged over `devices`; None where no device has a record in the window
    (a trace without the device's records, as on the CPU)."""
    busy = [_busy(tr, d) for d in devices]
    if not any(busy):
        return None
    cut = profiling._merged([(max(s, tr.t0), min(e, tr.t1)) for s, e in spans if min(e, tr.t1) > max(s, tr.t0)])
    if not cut:
        return 0.0
    a = np.array([s for s, _ in cut])
    b = np.array([e for _, e in cut])
    total = float(np.sum(b - a))
    idle = [total - (float(np.sum(_busy_before(ivs, b) - _busy_before(ivs, a))) if ivs else 0.0) for ivs in busy]
    return sum(idle) / len(idle) * 1e-6


def mean_ms(spans: Sequence[Interval]) -> Optional[float]:
    return sum(e - s for s, e in spans) / len(spans) * 1e-3 if spans else None


def step_partition(tr: profiling.Trace, devices) -> Optional[Dict[str, float]]:
    """The window's idle seconds split by what the host was in: each phase of
    the window's steps, the steps' unphased rest, and outside any step; the
    parts add up to `window`, the whole window's idle. None without a step
    or without device records."""
    steps = units(tr, STEP)
    whole = idle_s(tr, [(tr.t0, tr.t1)], devices)
    if not steps or whole is None:
        return None
    out = {k: idle_s(tr, inside(named(tr, name), steps), devices) for k, name in PHASES.items()}
    in_steps = idle_s(tr, steps, devices)
    out["unphased"] = in_steps - sum(out.values())
    out["outside"] = whole - in_steps
    out["window"] = whole
    return out


def phase_idle_ms(run, phase: str) -> Optional[float]:
    """Device idle ms a step while the host was in the window's steps'
    PHASES[phase] spans, averaged over the cards (None: no step, no device)."""
    if run.kind != "train" or run.trace is None:
        return None
    steps = units(run.trace, STEP)
    idle = idle_s(run.trace, inside(named(run.trace, PHASES[phase]), steps), run.device_ids) if steps else None
    return None if idle is None else idle * 1e3 / len(steps)
