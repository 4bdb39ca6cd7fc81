"""100 x the roofline time of a step's replay over the device time of replay_lanes_kernel."""
from benchmark import profiling, roofline


def read(run):
    work = run.work.get("replay")
    if run.kind != "train" or run.trace is None or work is None:
        return None
    per = profiling.kernel_seconds(run.trace, lambda n: "replay_lanes_kernel" in n)
    return roofline.share_percent(roofline.replay(work), sum(len(v) for v in per.values()),
                                  sum(sum(v) for v in per.values()))
