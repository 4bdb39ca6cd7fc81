"""100 x the roofline time of an emissive step's forward walk (roofline_emission.record:
the density's bound, plus the temperature corners read and each camera-path real
collision's emission) over the device time of the record instantiation of
trace_lanes_kernel (template <., ., true>)."""
from benchmark import profiling, roofline, roofline_emission


def read(run):
    work = run.work.get("record")
    if run.kind != "train" or run.trace is None or not isinstance(work, roofline_emission.Work):
        return None
    per = profiling.kernel_seconds(run.trace, lambda n: "trace_lanes_kernel" in n and "true>" in n)
    return roofline.share_percent(roofline_emission.record(work), sum(len(v) for v in per.values()),
                                  sum(sum(v) for v in per.values()))
