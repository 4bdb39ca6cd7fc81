"""100 x the roofline time of a step's forward walk over the device time of
the record instantiation of trace_lanes_kernel (template <., ., true>)."""
from benchmark import profiling, roofline


def read(run):
    work = run.work.get("record")
    if run.kind != "train" or run.trace is None or work is None:
        return None
    per = profiling.kernel_seconds(run.trace, lambda n: "trace_lanes_kernel" in n and "true>" in n)
    return roofline.share_percent(roofline.record(work), sum(len(v) for v in per.values()),
                                  sum(sum(v) for v in per.values()))
