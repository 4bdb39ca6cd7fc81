"""Every cell of BENCHMARK.json resolves, by name, to its files, and the
file keeps to the benchmark's contract."""
import importlib
import json
import os
import re

import pytest

from benchmark import run

ROOT = run.ROOT
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_by_name(cell):
    c = run.Cell(cell)
    assert os.path.exists(os.path.join(ROOT, next(x["file"] for x in SPEC["configs"] if x["name"] == c.workload["config"])))
    d = run.driver(c.mix["driver"])
    assert callable(d.drive) and callable(d.control) and d.KIND in ("render", "train")
    assert c.mix["devices"] == c.workload["chips"]
    assert set(c.limits) and all(isinstance(v, (int, float)) for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names
    assert set(c.readers) == names | {m["name"] for m in c.per_layer}


def test_contract_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert all(not p.startswith("/") and ".." not in p for p in SPEC["paths"])
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    every = [m["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for m in SPEC[k]]
    assert all(NAME.match(n) for n in every)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({m["name"] for m in SPEC[k]}) == len(SPEC[k])
    cells = {w["name"] for w in SPEC["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(cells)
    assert all(len(w["why"]) <= 200 for w in SPEC["workloads"] + SPEC["configs"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m["workloads"]) <= cells
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("cfg", [c["name"] for c in SPEC["configs"]])
def test_configuration_files(cfg):
    c = next(x for x in SPEC["configs"] if x["name"] == cfg)
    body = json.load(open(os.path.join(ROOT, c["file"])))
    assert body["reduced"] == c["reduced"] and set(body["reduced"]) <= set(body["assumed"])
    assert body["source"] and body["output_size"] and body["max_iters"] > 0
    assert callable(importlib.import_module("benchmark.recipes." + body["volume"]["recipe"]).make)
