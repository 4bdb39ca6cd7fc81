"""The share of the window's train steps (train.step spans) that replayed the
step's CUDA graph, each holding one train.replay span. 0 where every step
ran eagerly (a program without the graph); None without steps (a render
cell, or a trace without the spans)."""
from benchmark import spans


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    steps = spans.units(run.trace, spans.STEP)
    if not steps:
        return None
    return spans.count_inside(run.trace, ("train.replay",), steps) / len(steps)
