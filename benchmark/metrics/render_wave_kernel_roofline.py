"""100 x the roofline time of a wave's work over the device time of its
render_wave_kernel launches (summed over the cards that share the wave)."""
from benchmark import profiling, roofline


def read(run):
    work = run.work.get("wave")
    if run.kind != "render" or run.trace is None or work is None:
        return None
    per = profiling.kernel_seconds(run.trace, lambda n: "render_wave_kernel" in n)
    launches = sum(len(v) for v in per.values())
    waves = launches // len(run.devices)
    return roofline.share_percent(roofline.wave(work), waves, sum(sum(v) for v in per.values()))
