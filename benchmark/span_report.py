"""One traced run of a cell, and where its time went by the port's spans.

    python3 benchmark/span_report.py --workload CELL --seed N --seconds S [--parts K] [--out FILE]

Runs the cell as `benchmark/run.py --trace 1` does (the same driver, window
and check) and prints its result line, then one JSON line (also written to
FILE). For each of K equal parts of the traced window, over the waves or
steps that start in it, per unit: for each span of the port, its count, host
ms, the CUDA runtime calls (launches, memsets, copies) and syncs that start
inside it, and the device's idle ms while the host was in it; the idle ms
in the units and outside them; each card's kernel ms by kernel; for a train
cell the idle partition (spans.step_partition). Besides: the host ms of
each call into the program (Window.call_s), and for a one-card
render cell the clock check of render.launch spans against the
render_wave_kernel records they launch. A program without the spans gives
the kernel times and the calls' host ms.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness, profiling, run, spans  # noqa: E402

NAMES = {"render": ("render.wave", "render.film", "render.launch", "shard.wave", "shard.cell", "shard.gather",
                    "shard.copy", "kernel.constants"),
         "train": ("train.step", *spans.PHASES.values(), "prb.replay", "kernel.constants")}
KERNELS = ("render_wave_kernel", "trace_lanes_kernel", "replay_lanes_kernel")
CALLS = profiling.LAUNCH_CALLS + profiling.OTHER_CALLS


def part(tr: profiling.Trace, kind: str, devices) -> dict:
    """The table of one part of the window (tr's t0 and t1 are the part's)."""
    top = spans.wave_units(tr) if kind == "render" else spans.units(tr, spans.STEP)
    n = len(top) or None
    out = {"seconds": (tr.t1 - tr.t0) * 1e-6, "units": len(top), "spans": {}}
    kern = {}
    for k in KERNELS:
        per = profiling.kernel_seconds(tr, lambda name, k=k: k in name)
        if per:
            kern[k] = {d: {"launches": len(v), "ms": sum(v) * 1e3} for d, v in sorted(per.items())}
    out["kernels"] = kern
    if n is None:
        return out
    for name in NAMES[kind]:
        ivs = spans.inside(spans.named(tr, name), top)
        if not ivs:
            continue
        idle = spans.idle_s(tr, ivs, devices)
        out["spans"][name] = {"count": len(ivs) / n, "host_ms": sum(e - s for s, e in ivs) * 1e-3 / n,
                              "calls": spans.count_inside(tr, CALLS, ivs) / n,
                              "syncs": spans.count_inside(tr, spans.SYNCS, ivs) / n,
                              "idle_ms": None if idle is None else idle * 1e3 / n}
    whole, inner = spans.idle_s(tr, [(tr.t0, tr.t1)], devices), spans.idle_s(tr, top, devices)
    if whole is not None:
        out["idle_ms"] = {"part": whole * 1e3 / n, "in_units": inner * 1e3 / n, "outside": (whole - inner) * 1e3 / n}
    if kind == "train":
        p = spans.step_partition(tr, devices)
        if p is not None:
            out["partition_ms"] = {k: v * 1e3 / n for k, v in p.items()}
    return out


def clock_check(tr: profiling.Trace, device: int = 0) -> dict:
    """The render_wave_kernel records of the window against the render.launch
    spans that launch them. With one launch a span and no record lost, the
    k-th record is the k-th span's: its lag (record start - span start) is
    then read for each; otherwise each record is set against the latest span
    that starts before it, and a span with no record or with two counts."""
    starts = np.array([s for s, _ in spans.units(tr, "render.launch")])
    recs = np.array(sorted(s for d, name, s, _ in tr.device
                           if d == device and "render_wave_kernel" in name and tr.t0 <= s <= tr.t1))
    out = {"launch_spans": int(starts.size), "kernel_records": int(recs.size)}
    if not starts.size or not recs.size:
        return out
    if starts.size == recs.size:
        lag = recs - starts
        late = np.flatnonzero(lag < 0)
        out.update(paired_in_order=True, records_before_their_span=int(late.size),
                   before_at_s=[round(float(starts[i] - tr.t0) * 1e-6, 4) for i in late[:40]])
    else:
        k = np.searchsorted(starts, recs, side="right") - 1
        per = np.bincount(k[k >= 0], minlength=starts.size)
        lag = recs[k >= 0] - starts[k[k >= 0]]
        out.update(paired_in_order=False, records_before_any_span=int((k < 0).sum()),
                   spans_without_record=int((per == 0).sum()), spans_with_two_or_more=int((per > 1).sum()))
    q = np.percentile(lag, [0, 1, 50, 99, 100])
    out["lag_us"] = dict(zip(("min", "p1", "median", "p99", "max"), (float(x) for x in q)))
    return out


def report(r: harness.Run, parts: int) -> dict:
    tr = r.trace
    edges = np.linspace(tr.t0, tr.t1, parts + 1)
    out = {"kind": r.kind, "units": r.window.units,
           "call_ms": {"mean": 1e3 * statistics.fmean(r.window.call_s),
                       "median": 1e3 * statistics.median(r.window.call_s)},
           "parts": [part(tr._replace(t0=float(a), t1=float(b)), r.kind, r.device_ids)
                     for a, b in zip(edges[:-1], edges[1:])]}
    if r.kind == "render" and len(r.device_ids) == 1:
        out["clock_check"] = clock_check(tr, r.device_ids[0])
    return out


class _Kept(harness.Run):
    """harness.Run that keeps the last instance made, so the trace that
    run_cell reads is reported too."""

    last = None

    def __init__(self, *a):
        super().__init__(*a)
        _Kept.last = self


def main(argv=None) -> int:
    t0 = run.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--parts", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    chips = run.Cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"span_report: the cell needs {chips} CUDA device(s)", file=sys.stderr)
        return run.NO_DEVICE
    harness.Run = _Kept
    result = run.run_cell(args.workload, args.seed, args.seconds, True, t0=t0)
    print(json.dumps(result), flush=True)
    rep = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds, **report(_Kept.last, args.parts)}
    print(json.dumps(rep), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"result": result, "report": rep}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
