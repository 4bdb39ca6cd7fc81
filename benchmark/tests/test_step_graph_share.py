"""step_graph_share (benchmark/metrics/step_graph_share.py) on hand-built
traces: 0 where no step holds a train.replay span, 1.0 where every step in
the window does (a replay outside any step, or in a step before the window,
counts for nothing), the share where some do, and None without steps."""
import os

import pytest
import torch

from benchmark import harness, profiling, run

READ = run._reader(os.path.join(run.ROOT, "benchmark", "metrics", "step_graph_share.py"))
EAGER = [("train.step", 0, 300), ("train.optimizer", 0, 10), ("train.rebuild", 10, 50), ("train.rays", 50, 70),
         ("prb.record", 70, 150), ("train.backward", 150, 250), ("train.optimizer", 260, 300)]
REPLAYED = [("train.step", 0, 120), ("train.replay", 5, 110)]


def _run(kind, cpu):
    r = harness.Run([torch.device("cuda", 0)], (0.0, 0.0))
    r.kind = kind
    r.trace = profiling.Trace(0.0, 1000.0, [(0, "k", 10.0, 900.0)], cpu, {})
    return r


def _steps(*bodies):
    """The steps one after another, 250 us apart from t = -200 (one before the window)."""
    cpu = []
    for i, body in enumerate(bodies):
        t = -200 + 250 * i
        cpu += [(n, float(t + s), float(t + e)) for n, s, e in body]
    return cpu


def test_no_replay_reads_zero():
    assert READ(_run("train", _steps(EAGER, EAGER, EAGER, EAGER))) == 0.0


def test_a_replay_in_every_step_reads_one():
    cpu = _steps(EAGER, REPLAYED, REPLAYED, REPLAYED, REPLAYED) + [("train.replay", 990.0, 995.0)]
    assert READ(_run("train", cpu)) == 1.0


def test_some_steps_replayed():
    assert READ(_run("train", _steps(REPLAYED, EAGER, REPLAYED, EAGER, REPLAYED))) == pytest.approx(2 / 4)


@pytest.mark.parametrize("kind,cpu", [("train", []), ("train", [("train.replay", 5.0, 110.0)]),
                                      ("render", _steps(REPLAYED, REPLAYED))],
                         ids=["no_spans", "replay_without_steps", "render_cell"])
def test_without_steps_reads_none(kind, cpu):
    assert READ(_run(kind, cpu)) is None


def test_without_a_trace_reads_none():
    r = _run("train", _steps(REPLAYED))
    r.trace = None
    assert READ(r) is None
