"""Named spans at the port's layer boundaries, on torch.profiler's clock.

A span is recorded only while a torch.profiler profile runs (the profiler
being on is the switch: cli --profile, or a caller's own profile); otherwise
span() hands back one shared no-op context, at the cost of one C call. The
profiler keeps each span's name, start and end beside its CPU ops and the
device's records, so a reader can put the device's idle time down to the
span the host was in. SPANS names every span the package records.
"""
from __future__ import annotations

import contextlib

import torch

SPANS = (
    "render.wave", "render.film", "render.launch",
    "shard.wave", "shard.cell", "shard.gather", "shard.copy",
    "train.step", "train.rebuild", "train.rays", "train.backward", "train.optimizer",
    "train.capture", "train.replay",
    "prb.record", "prb.replay", "prb.fold",
    "medium.build", "kernel.build", "kernel.constants",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range called `name` while a profiler runs, else a no-op
    context. The range is torch's _RecordFunctionFast, the one Inductor's
    generated code records: a host op event of that name and nothing on the
    device, several times cheaper than torch.profiler.record_function, so a
    traced wave's host time stays near that of a trace without spans."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
