"""Two processes of the port's multi-process example against one, on the CPU.

The counterpart of tests/test_multiprocess.py (which JAX marks slow; this
one is not): two OS processes join a torch.distributed job (gloo, a
localhost TCP rendezvous), each lays 4 cells on the CPU, and run
volume_path_tracer_tpu_torch/examples/multihost_render.py's worker at a
tiny size: global_mesh (4x2, each process's cells together along 'spp'),
one sharded wave, the film gathered to process 0, and one train step whose
gradients are summed across the processes. Process 0's film, gradients and
loss must be identical to one process's on the same 8 cells: the film's
cross-process sum adds zeros to disjoint rows, and the gradient's sum over
a process's 4 cells, then across 2 processes, takes the pairwise order of
one process's sum over 8 (shard.tree_sum).
"""
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--cpu", "--size", "8", "--waves", "1", "--spp-axis", "2", "--train", "--train-size", "8",
        "--train-steps", "1", "--train-iters", "48"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_give_one_process_film_and_gradients(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    worker = [sys.executable, "-m", "volume_path_tracer_tpu_torch.examples.multihost_render", *ARGS]
    coord = f"127.0.0.1:{_free_port()}"
    runs = [(worker + ["--local-cells", "8", "--dump", str(tmp_path / "one.npz")])]
    runs += [worker + ["--local-cells", "4", "--coordinator", coord, "--num-processes", "2", "--process-id",
                       str(i), "--dump", str(tmp_path / "two.npz")] for i in range(2)]
    procs = [subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in runs]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "[multihost] 2 processes, mesh {'rays': 4, 'spp': 2}" in outs[1]
    assert "[multihost] 1 processes, mesh {'rays': 4, 'spp': 2}" in outs[0]
    one, two = np.load(tmp_path / "one.npz"), np.load(tmp_path / "two.npz")
    assert sorted(one.files) == sorted(two.files) == ["film", "grad_density", "grad_temperature", "loss0", "npix"]
    assert int(two["npix"]) == 64 and two["film"].shape == (8, 8, 4) and (two["film"][..., 3] == 2).all()
    for k in one.files:
        np.testing.assert_array_equal(two[k], one[k], err_msg=k)
    assert np.abs(two["grad_density"]).max() > 0 and np.abs(two["grad_temperature"]).max() > 0
    # the lane-iterations a wave, a pure count, are the same in both runs
    lanes = [line.split(" lane-iterations/wave")[0].rsplit(" ", 1)[1]
             for line in (outs[0], outs[1]) for line in line.splitlines() if "lane-iterations/wave" in line]
    assert len(lanes) == 2 and lanes[0] == lanes[1], lanes
