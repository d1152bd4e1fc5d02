"""Multi-PROCESS distributed pose-graph optimization of rgbdslam_tpu_torch
(the counterpart of tests/test_multiprocess.py).

Launches 2 OS processes, each with 4 shards of the CPU, joined through
torch.distributed over a TCP store (gloo). The edge-sharded matrix-free CG
LM then runs over the 2 x 4 = 8-shard global mesh, its reductions
all-gathered across the processes, and every process checks its result
against its local dense solve (within 5e-3, as the JAX test), against the
ground truth, and bit for bit against the same solve on a one-process mesh
of 8 shards (the partials are added in the same shard order).
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker_env() -> dict:
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "2"      # several workers share the host's cores
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _launch(num_processes: int, port: int, extra=()):
    procs = []
    for pid in range(num_processes):
        cmd = [
            sys.executable, "-m", "rgbdslam_tpu_torch.parallel.multihost",
            "--coordinator", f"localhost:{port}",
            "--num-processes", str(num_processes),
            "--process-id", str(pid),
            "--platform", "cpu", "--devices-per-process", "4",
            "--vertices", "48", "--edges", "192",
            "--iterations", "6", "--cg-iters", "48",
            "--check", *extra,
        ]
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=worker_env(), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    results = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        results.append(json.loads(line))
    return results


def test_two_process_distributed_pose_graph():
    results = _launch(2, free_port())
    assert results[0]["global_devices"] == 8
    assert results[0]["processes"] == 2 and results[0]["backend"] == "gloo"
    for r in results:
        # the distributed CG result matches each process's local dense solve
        assert r["check_ok"], r
        assert r["max_diff_vs_dense"] < 5e-3
        # and recovers the ground-truth poses (noise-free measurements)
        assert r["max_translation_err"] < 5e-3
        # and equals the one-process mesh of 8 shards bit for bit
        assert r["equal_one_process"], r
        # 6 GN iterations: 3 reductions each, and one a CG iteration
        assert r["reductions"] == 6 * (3 + 48)
    # every process holds the same bits
    assert results[0]["final_cost"] == results[1]["final_cost"]


def test_two_process_async_constraint_exchange():
    """Loop constraints discovered on one process reach the other over the
    asynchronous TCP channel (no collective, no barrier) BEFORE the solve:
    each process withholds one loop edge, publishes it, merges the peer's,
    and the distributed solve still matches the full-edge-set dense solve."""
    results = _launch(2, free_port(), extra=("--exchange",))
    for r in results:
        assert r["exchanged_constraints"] == 1, r
        assert r["check_ok"], r
