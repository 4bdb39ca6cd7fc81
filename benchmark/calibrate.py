"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/calibrate.py --workload CELL --seeds S1,S2,... [--seconds 2] [--control S1,S2,S3]

For every seed of --seeds: a whole run of the cell (set-up, a short window
at the cell's own load, the check) and its compared numbers, unbounded by
the cell's limits: the largest over a dozen seeds or more is a limit's
lower reading. For every seed of --control: the control, the reference
computed in bfloat16 and put in the program's place (the cell's driver's
`control`: render cells the same seeded sample of waves and pixels,
training cells the reference's first steps), whose smallest reading is a
limit's upper one, and for a training cell each fault's reading, planted
in the reference. One JSON line per
reading. The benchmark's own runs never run this.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from benchmark import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", default="")
    ap.add_argument("--cpu", action="store_true", help="the plain path on the CPU: a check of this script only")
    args = ap.parse_args(argv)
    dev = "cpu" if args.cpu else "cuda"
    for s in filter(None, args.seeds.split(",")):
        res = run.run_cell(args.workload, int(s), args.seconds, False, device_type=dev)
        print(json.dumps({"seed": int(s), "program": {k: v["value"] for k, v in res["checks"].items()},
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "forbidden": run.forbidden_modules()}),
              flush=True)
    cell = run.Cell(args.workload)
    for s in filter(None, args.control.split(",")):
        print(json.dumps({"seed": int(s), **run.driver(cell.mix["driver"]).control(cell, int(s), torch.device(dev))}),
              flush=True)
        if dev == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
