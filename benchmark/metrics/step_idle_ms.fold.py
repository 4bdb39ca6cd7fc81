"""Device idle milliseconds a train step while the host was inside the step's
prb.fold spans (the corner-row tables folded into the gradient grids, inside
prb.replay), averaged over the cards. None for a program without the span."""
from benchmark import spans

FOLD = "prb.fold"


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    steps = spans.units(run.trace, spans.STEP)
    folds = spans.inside(spans.named(run.trace, FOLD), steps)
    if not folds:
        return None
    idle = spans.idle_s(run.trace, folds, run.device_ids)
    return None if idle is None else idle * 1e3 / len(steps)
