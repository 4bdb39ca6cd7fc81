"""The slowest card's render_wave_kernel time in a wave over the cards' mean,
averaged over the traced waves (the k-th launch on each card is wave k's)."""
from benchmark import profiling


def read(run):
    if run.kind != "render" or run.trace is None or len(run.devices) < 2:
        return None
    per = profiling.kernel_seconds(run.trace, lambda n: "render_wave_kernel" in n)
    lists = [per.get(d, []) for d in run.device_ids]
    n = min(len(v) for v in lists)
    if n == 0:
        return None
    ratios = [max(v[k] for v in lists) / (sum(v[k] for v in lists) / len(lists)) for k in range(n)]
    return sum(ratios) / n
