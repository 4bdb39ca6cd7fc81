"""Kernel launches, memsets and copies the host issued a train step, from the
profiler's CUDA runtime records over the traced window."""
from benchmark import profiling


def read(run):
    if run.kind != "train" or run.trace is None or not run.window.units:
        return None
    calls = sum(v for k, v in run.trace.calls.items() if k in profiling.LAUNCH_CALLS + profiling.OTHER_CALLS)
    return calls / run.window.units if calls else None
