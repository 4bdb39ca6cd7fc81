"""Mean host milliseconds of the window's waves, from the port's own span
around each (render.wave; shard.wave on a mesh)."""
from benchmark import spans


def read(run):
    if run.kind != "render" or run.trace is None:
        return None
    return spans.mean_ms(spans.wave_units(run.trace))
