"""100 x the roofline time of an emissive step's replay (roofline_emission.replay: the
density's bound, plus the temperature corners read and their gradient rows written, and
each camera-path real collision's emission and its two derivatives) over the device time
of replay_lanes_kernel."""
from benchmark import profiling, roofline, roofline_emission


def read(run):
    work = run.work.get("replay")
    if run.kind != "train" or run.trace is None or not isinstance(work, roofline_emission.Work):
        return None
    per = profiling.kernel_seconds(run.trace, lambda n: "replay_lanes_kernel" in n)
    return roofline.share_percent(roofline_emission.replay(work), sum(len(v) for v in per.values()),
                                  sum(sum(v) for v in per.values()))
