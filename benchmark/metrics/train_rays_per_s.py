"""Lanes (pixels x samples) of the steps completed over the whole window / seconds."""


def read(run):
    if run.kind != "train":
        return None
    return run.lanes_per_unit * run.window.units / run.window.seconds
