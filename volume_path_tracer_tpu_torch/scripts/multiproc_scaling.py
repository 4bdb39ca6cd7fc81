"""Multi-process scaling table of the port's multi-process example.

Port of scripts/multiproc_scaling.py. Launches
volume_path_tracer_tpu_torch/examples/multihost_render.py at 1, 2 and 4
processes joined over a localhost TCP rendezvous (gloo on the CPU with
--cpu, 2 cells a process; on the card NCCL, one cell a process on
cuda:LOCAL_RANK, or --backend gloo for processes that share a card) and
prints rays/s, iterations/s a cell and the film's mean weight for each.
Processes that share cores or a card measure contention, not scaling; the
lane-iterations a wave, the same at every topology, show that no work is
duplicated or skipped.

    python -m volume_path_tracer_tpu_torch.scripts.multiproc_scaling [--cpu] [--size 128] [--waves 2] [--out FILE]

Writes a markdown table to --out only when it is given.
"""
from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_topology(n_procs: int, cells: int, size: int, waves: int, cpu: bool, backend=None, timeout=1200):
    """Run the example in n_procs processes; returns process 0's (rays/s,
    iters/s a cell, lane-iterations a wave, film mean weight, wall s)."""
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = []
    t0 = time.perf_counter()
    try:
        for pid in range(n_procs):
            cmd = [sys.executable, "-m", "volume_path_tracer_tpu_torch.examples.multihost_render",
                   "--size", str(size), "--waves", str(waves), "--local-cells", str(cells)]
            cmd += ["--cpu"] if cpu else []
            cmd += ["--backend", backend] if backend else []
            if n_procs > 1:
                cmd += ["--coordinator", coord, "--num-processes", str(n_procs), "--process-id", str(pid)]
            procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True, cwd=REPO))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"a process of {n_procs} failed:\n{out[-2000:]}")
    out0 = outs[0]
    m = re.search(r"rays in ([\d.]+)s", out0)
    mi = re.search(r"([\d.]+) iters/s/device", out0)
    ml = re.search(r"(\d+) lane-iterations/wave", out0)
    mw = re.search(r"mean w ([\d.]+)", out0)
    if not (m and mi and ml and mw):
        raise RuntimeError(f"unexpected output:\n{out0[-2000:]}")
    return size * size * waves / float(m.group(1)), float(mi.group(1)), int(ml.group(1)), float(mw.group(1)), wall


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU, 2 cells a process")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None)
    ap.add_argument("--out", default=None, metavar="FILE", help="write the table here")
    args = ap.parse_args(argv)

    cells = 2 if args.cpu else 1
    rows = []
    for n_procs in (1, 2, 4):
        rays, ips, lanes, mean_w, wall = run_topology(n_procs, cells, args.size, args.waves, args.cpu,
                                                      args.backend)
        rows.append((n_procs, cells, n_procs * cells, rays, ips, lanes, mean_w, wall))
        print(f"{n_procs} proc x {cells} cells: {rays:,.0f} rays/s, {ips} iters/s/cell, {lanes} lane-iterations/"
              f"wave, mean_w={mean_w}, wall {wall:.0f}s", flush=True)
    if len({r[5] for r in rows}) != 1 or len({r[6] for r in rows}) != 1:
        raise RuntimeError(f"lane-iterations or film weights differ across topologies: {rows}")
    table = ("| processes | cells/proc | cells | rays/s total | iters/s/cell | lane-iterations/wave | film mean w "
             "| wall s |\n|---|---|---|---|---|---|---|---|\n")
    table += "".join(f"| {n} | {c} | {g} | {r:,.0f} | {i} | {l} | {w} | {t:.0f} |\n"
                     for n, c, g, r, i, l, w, t in rows)
    print(table, end="")
    if args.out:
        with open(args.out, "w") as f:
            f.write(f"`multihost_render` at {args.size}x{args.size}, {args.waves} waves, "
                    f"{'gloo on the CPU' if args.cpu else args.backend or 'nccl'}\n\n" + table)
        print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
