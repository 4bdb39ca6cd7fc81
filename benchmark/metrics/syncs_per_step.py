"""Host synchronizations (CUDA runtime records of a stream, device or event
sync) that start inside the window's train.step spans, per step."""
from benchmark import spans


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    steps = spans.units(run.trace, spans.STEP)
    if not steps:
        return None
    return spans.count_inside(run.trace, spans.SYNCS, steps) / len(steps)
