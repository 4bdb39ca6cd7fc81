"""What the benchmark reads from a torch.profiler trace of its window.

Device busy time counts CUPTI's kernel, memset and copy records, without the
device-side ranges of user annotations (they would count their kernels
twice), as the repository's chip_smoke.py device_split does. Host calls are
counted from the CUDA runtime records, as its host_calls does.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

WINDOW = "bench.window"
OUTSIDE = "host Python outside any torch op (the loop, the port's wrappers, ctypes launches)"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
OTHER_CALLS = ("cudaMemsetAsync", "cudaMemcpyAsync")


class Trace(NamedTuple):
    t0: float  # the window, microseconds on the profiler's clock
    t1: float
    device: List[Tuple[int, str, float, float]]  # (device index, name, start, end) of device records
    cpu: List[Tuple[str, float, float]]  # host ops and spans
    calls: Dict[str, int]  # CUDA runtime calls by name

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6


@contextlib.contextmanager
def maybe_profile(on: bool, cuda: bool):
    """A torch.profiler.profile around the block when `on` (None otherwise)."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof


def read(prof) -> Optional[Trace]:
    """The window's records from a finished profile."""
    from torch.autograd import DeviceType

    evs = prof.events()
    win = [e for e in evs if e.name == WINDOW]
    if not win:
        return None
    t0, t1 = win[0].time_range.start, win[0].time_range.end
    device, cpu = [], []
    calls = defaultdict(int)
    for e in evs:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
                continue
            device.append((int(e.device_index), e.name, float(e.time_range.start), float(e.time_range.end)))
        else:
            cpu.append((e.name, float(e.time_range.start), float(e.time_range.end)))
            if e.name in LAUNCH_CALLS or e.name in OTHER_CALLS:
                if t0 <= e.time_range.start <= t1:
                    calls[e.name] += 1
    return Trace(t0, t1, device, cpu, dict(calls))


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(tr: Trace, devices) -> Dict[int, float]:
    """Seconds of the window in which some operation ran, per device."""
    per = defaultdict(list)
    for d, _, s, e in tr.device:
        s, e = max(s, tr.t0), min(e, tr.t1)
        if e > s:
            per[d].append((s, e))
    return {d: sum(e - s for s, e in _merged(per.get(d, []))) * 1e-6 for d in devices}


def kernel_seconds(tr: Trace, match) -> Dict[int, List[float]]:
    """Durations (s) of the window's device records whose name `match`es, per device, in order."""
    per = defaultdict(list)
    for d, name, s, e in sorted(tr.device, key=lambda r: r[2]):
        if tr.t0 <= s <= tr.t1 and match(name):
            per[d].append((e - s) * 1e-6)
    return dict(per)


def device_ops(tr: Trace, top: int = 10):
    """The device operations that took most time in the window: [[name, seconds]]."""
    tot = defaultdict(float)
    for _, name, s, e in tr.device:
        if tr.t0 <= s <= tr.t1:
            tot[name] += (e - s) * 1e-6
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(tr: Trace, device: int, top: int = 10, examine: int = 2000):
    """The device's idle time in the window by what the host was doing then
    (the innermost host op or span over each gap's middle): [[name, seconds]],
    the longest `examine` gaps summed by name."""
    busy = _merged([(max(s, tr.t0), min(e, tr.t1)) for d, _, s, e in tr.device
                    if d == device and min(e, tr.t1) > max(s, tr.t0)])
    edges = [tr.t0] + [x for iv in busy for x in iv] + [tr.t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:examine]
    if not gaps:
        return []
    ops = [c for c in tr.cpu if c[0] != WINDOW]
    names = [c[0] for c in ops]
    starts = np.array([c[1] for c in ops])
    ends = np.array([c[2] for c in ops])
    tot = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        label = names[inside[np.argmin(ends[inside] - starts[inside])]] if inside.size else OUTSIDE
        tot[label] += (e - s) * 1e-6
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
