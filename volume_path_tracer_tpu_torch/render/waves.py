"""Wave orchestration: progress/ETA, graceful stop, checkpointing.

Copy of volume_path_tracer_tpu/render/waves.py (numpy only). Parity with the
reference renderer's TileProvider and GUI loop: progress = waves done /
total with an ETA extrapolated from the average rate; the first ^C stops at
the next wave boundary (the film is then a valid lower-sample snapshot and
is saved), a second ^C stops at once; wave boundaries are consistent
snapshots, so a render can checkpoint and resume where it stopped.
"""
from __future__ import annotations

import os
import signal
import time

import numpy as np


class ProgressTracker:
    """Progress/ETA with the reference's average-rate extrapolation."""

    def __init__(self, total_waves: int):
        self.total = total_waves
        self.done = 0
        self.start_t = time.monotonic()

    def advance(self, waves: int = 1):
        self.done += waves

    @property
    def ratio(self) -> float:
        return self.done / max(self.total, 1)

    @property
    def percent(self) -> int:
        return int(self.ratio * 100.0)

    def eta_seconds(self) -> float:
        p = self.ratio
        if p <= 0:
            return float("inf")
        rate = p / (time.monotonic() - self.start_t + 1e-9)
        return (1.0 - p) / rate

    def format(self) -> str:
        eta = self.eta_seconds()
        if not np.isfinite(eta):
            return f"{self.percent}% - ETA: --"
        mm, ss = int(eta // 60), int(eta % 60)
        return f"{self.percent}% - ETA: {mm}m {ss}s"  # main.cpp:119 format


class StopController:
    """SIGINT handling: first ^C = stop at next wave (graceful, image saved),
    second ^C = stop now. Improves on the reference, where CTRL+C loses the
    image (README.md:9) and only the GUI close saves it."""

    def __init__(self):
        self.stop_at_next_wave = False
        self.force_stop = False
        self._prev = None

    def __enter__(self):
        def handler(signum, frame):
            if self.stop_at_next_wave:
                self.force_stop = True
            else:
                self.stop_at_next_wave = True
                print(flush=True)
                from ..utils import logging as vlog

                vlog.info(
                    "stop requested - finishing current wave "
                    "(press ^C again to abort without saving)"
                )

        self._prev = signal.signal(signal.SIGINT, handler)
        return self

    def __exit__(self, *exc):
        signal.signal(signal.SIGINT, self._prev)
        return False


def save_checkpoint(path: str, film: np.ndarray, wave: int, seed: int) -> None:
    """Persist a wave-boundary snapshot (film + counters): resume-able."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, film=film, wave=wave, seed=seed)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Returns (film, wave, seed) or None."""
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return z["film"], int(z["wave"]), int(z["seed"])
