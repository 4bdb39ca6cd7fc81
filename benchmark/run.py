"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

CELL is a `workloads` entry of BENCHMARK.json. Its configuration, traffic
mix, driver, limits and metric readers are files found by name:
benchmark/configs/<config>.json (its `volume.recipe`:
benchmark/recipes/<recipe>.py), benchmark/traffic/<traffic>.json (data:
sizes, devices, the check's sample), benchmark/drivers/<driver>.py (the
mix's `driver`: set-up, window loop and check), benchmark/limits/<cell>.json
and benchmark/metrics/<metric>.py (read(run) -> number or None).

Set-up (process start to the first timed wave or step) makes the grids on
the card from the seed, builds the program's objects and warms up the
cell's shapes; the window runs for S seconds; then, with the program's
state freed, the reference decides `correct`. With --trace 1 the same window
runs under torch.profiler and the line carries the per-layer metrics.
Needs CUDA with the cell's number of devices: without them it exits 3
and prints no result. If JAX or the JAX package got loaded by the time the
result is ready (the check and the readers included), it exits 4 and
prints no result.
"""
from __future__ import annotations

import os
import sys
import time

_T_TOP = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
from typing import Optional  # noqa: E402

import torch  # noqa: E402

from benchmark import harness, profiling, roofline  # noqa: E402

_T_IMPORTED = time.time()

FORBIDDEN = ("jax", "jaxlib", "flax", "volume_path_tracer_tpu")
NO_DEVICE = 3
FORBIDDEN_LOADED = 4


def process_start() -> float:
    """This process's start on the wall clock (from /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Cell:
    """A workload and everything found for it by name."""

    def __init__(self, name: str, root: str = ROOT, sizes: Optional[dict] = None):
        spec = _load_json(os.path.join(root, "BENCHMARK.json"))
        here = os.path.join(root, "benchmark")
        self.workload = next(w for w in spec["workloads"] if w["name"] == name)
        conf = next(c for c in spec["configs"] if c["name"] == self.workload["config"])
        sizes = sizes or {}
        self.config = _merge(_load_json(os.path.join(root, conf["file"])), sizes.get("config"))
        self.mix = _merge(_load_json(os.path.join(here, "traffic", self.workload["traffic"] + ".json")),
                          sizes.get("mix"))
        self.limits = _load_json(os.path.join(here, "limits", name + ".json"))
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
        self.readers = {m["name"]: _reader(os.path.join(here, "metrics", m["name"] + ".py"))
                        for m in self.end_to_end + self.per_layer}


def _reader(path):
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + os.path.basename(path)[:-3]
                                                  .replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def driver(name: str):
    """The driver module a mix names (benchmark/drivers/<name>.py)."""
    return importlib.import_module("benchmark.drivers." + name)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device_type: str = "cuda",
             sizes: Optional[dict] = None, root: str = ROOT, t0: Optional[float] = None):
    """Run the cell; its result dict. device_type="cpu" and `sizes`
    (overrides of the configuration and mix) are for tests only."""
    t0 = process_start() if t0 is None else t0
    cell = Cell(name, root, sizes)
    n = cell.mix["devices"]
    if n != cell.workload["chips"]:
        raise ValueError(f"{name}: its mix drives {n} devices, the cell asks for {cell.workload['chips']}")
    devices = [torch.device("cuda", i) for i in range(n)] if device_type == "cuda" else [torch.device("cpu")] * n
    run = harness.Run(devices, (_T_TOP, _T_IMPORTED))
    readings = driver(cell.mix["driver"]).drive(cell, run, seed, seconds, trace, t0)
    correct = all(r.value <= r.limit for r in readings.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.readers[m["name"]](run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    cuda = devices[0].type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": n, "memory_peak_bytes": run.peak_bytes}
    result = {"correct": correct, "attempted": run.window.units, "failed": 0, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        busy = profiling.busy_s(run.trace, run.device_ids)
        device["busy_s"] = sum(busy.values()) / len(busy)
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": profiling.device_ops(run.trace),
                               "idle_gaps": profiling.idle_gaps(run.trace, run.device_ids[0])}
    result["checks"] = {k: {"value": r.value, "limit": r.limit} for k, r in readings.items()}
    for k, w in run.work.items():
        b = getattr(roofline, k)(w)
        print(f"benchmark: {name}: {k} work {w} -> bound {b.seconds * 1e3:.5f} ms, {b.binds} bind "
              f"({b.ops:.4g} operations, {b.bytes:.4g} bytes)", file=sys.stderr)
    parts = ", ".join(f"{k} {v:.2f}" for k, v in run.spans.items())
    print(f"benchmark: {name}: set-up {run.setup_s:.2f} s ({parts}), window {run.window.seconds:.2f} s "
          f"({run.window.units} units), check {run.check_s:.2f} s", file=sys.stderr)
    return result


def main(argv=None) -> int:
    t0 = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = Cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return NO_DEVICE
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    bad = forbidden_modules()  # after the window, the check and every reader
    if bad:
        print(f"benchmark: modules that must not load were loaded: {', '.join(bad)}", file=sys.stderr)
        return FORBIDDEN_LOADED
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
