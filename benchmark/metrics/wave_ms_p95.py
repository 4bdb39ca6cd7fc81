"""The 95th percentile of every wave's time in the window, from its issue
to its completion, timed by CUDA events on the first card: timestamps the
device writes as its stream reaches them (the device is idle between waves,
so the first marks the issue). A host-clock reading is off by some half a
millisecond, too coarse for waves of 1-4 ms, which the device's clock is not."""
import numpy as np


def read(run):
    if run.kind != "render" or not run.window.unit_ms:
        return None
    return float(np.percentile(np.asarray(run.window.unit_ms, dtype=np.float64), 95))
