"""What a driver fills in and the metric readers read (Run), and the steps
of set-up every driver shares."""
from __future__ import annotations

from typing import List, Optional

import torch

from . import profiling


class Run:
    """One run of one cell. A driver sets `kind` ("render": its units are
    waves of W x H camera rays; "train": steps of `lanes_per_unit` lanes),
    the window, set-up, the peak, the trace and the work the reference
    counted; the readers key on `kind` and read the rest."""

    def __init__(self, devices: List[torch.device], started: tuple):
        self.kind = ""
        self.devices = devices
        self.started = started  # (the harness's first line, its imports done), wall clock
        self.window = None  # program.Window
        self.lanes_per_unit = 0
        self.setup_s = 0.0
        self.peak_bytes = 0
        self.trace: Optional[profiling.Trace] = None
        self.work = {}  # roofline.Work by kernel ("wave", "record", "replay")
        self.spans = {}  # set-up phases: seconds by name
        self.check_s = 0.0

    @property
    def device_ids(self):
        return sorted({d.index or 0 for d in self.devices})


def startup_spans(run: Run, t0: float, now: float):
    """Set-up before the inputs: the interpreter's start, the imports (torch
    and the port), and the rest (the CUDA driver's start, the cell's files)."""
    top, imported = run.started
    run.spans["interpreter"] = max(0.0, top - t0)
    run.spans["imports"] = imported - top
    run.spans["cuda_init"] = now - max(t0, imported)


def peak(devices) -> int:
    if devices[0].type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(d) for d in set(devices))


def reset_peak(devices):
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
        for d in set(devices):
            torch.cuda.reset_peak_memory_stats(d)


def free(devices):
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()


def window_span():
    """The profiler range that marks the window, entered now."""
    rf = torch.profiler.record_function(profiling.WINDOW)
    rf.__enter__()
    return rf
