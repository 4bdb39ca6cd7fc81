"""Device idle milliseconds a wave while the host was inside the port's wave
span (render.wave; shard.wave on a mesh), averaged over the cards; the rest
of the window's idle time is the caller's loop and its sync."""
from benchmark import spans


def read(run):
    if run.kind != "render" or run.trace is None:
        return None
    waves = spans.wave_units(run.trace)
    idle = spans.idle_s(run.trace, waves, run.device_ids) if waves else None
    return None if idle is None else idle * 1e3 / len(waves)
