"""100 x (1 - device busy / traced window) of a training window."""
from benchmark import profiling


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    busy = profiling.busy_s(run.trace, run.device_ids)
    if not any(busy.values()):
        return None
    return 100.0 * (1.0 - sum(busy.values()) / len(busy) / run.trace.window_s)
