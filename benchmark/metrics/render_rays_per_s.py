"""Camera rays completed over the whole window: W x H x waves / seconds."""


def read(run):
    if run.kind != "render":
        return None
    return run.lanes_per_unit * run.window.units / run.window.seconds
