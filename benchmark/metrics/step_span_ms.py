"""Mean host milliseconds of the window's train steps, from the port's own
span around each (train.step)."""
from benchmark import spans


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return spans.mean_ms(spans.units(run.trace, spans.STEP))
