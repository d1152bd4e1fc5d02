"""Live SLAM of rgbdslam_tpu_torch across 2 OS processes (the counterpart
of tests/test_mp_slam.py, `slow` as that test is; chip_smoke.py's phase 13
runs it on the card).

Process 0 runs the full SlamSystem and publishes every graph mutation over
the asynchronous TCP constraint channel; process 1 is a backend peer
holding a live mirror that JOINS every solve over the 2 x 4 = 8-shard
global mesh (torch.distributed, gloo). Asserted, as the JAX test does:

  1. the peer's mirror consumed the complete live graph, vertex for vertex
     and edge for edge, with at least one LOOP constraint;
  2. every solve (the mid-run loop closure, the final one and a warm one)
     ran as a cross-process collective on both sides;
  3. the 2-process trajectory is within 5 cm of a one-process run of the
     same sequence (the dense solve against the distributed CG).
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
from test_torch_multiprocess import REPO, free_port, worker_env

FRAMES = 80


@pytest.mark.slow
def test_two_process_live_slam(tmp_path):
    port = free_port()
    traj_out = str(tmp_path / "traj.npz")
    procs = []
    for pid in range(2):
        cmd = [sys.executable, "-m", "rgbdslam_tpu_torch.parallel.mp_slam",
               "--coordinator", f"localhost:{port}", "--num-processes", "2",
               "--process-id", str(pid), "--platform", "cpu", "--devices-per-process", "4",
               "--frames", str(FRAMES)]
        if pid == 0:
            cmd += ["--out", traj_out]
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=worker_env(), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    results = {}
    for pid, p in enumerate(procs):
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, f"process {pid} failed:\n{err[-4000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        results[pid] = json.loads(line)

    r0, r1 = results[0], results[1]
    assert r0["global_devices"] == 8
    assert r0["loops_closed"] >= 1
    assert r0["dist_solves"] >= 2, r0      # the mid-run loop solve + the final one
    assert r0["ate_rmse"] < 0.10, r0
    # the peer consumed the COMPLETE live graph across the socket
    assert r1["vertices"] == r0["keyframes"], (r0, r1)
    n_peer_edges = r1["edges_odometry"] + r1["edges_proximity"] + r1["edges_loop"]
    assert n_peer_edges == r0["graph_edges"], (r0, r1)
    assert r1["edges_loop"] >= 1, r1
    # every solve was a cross-process collective, joined on both sides
    assert r1["solves_joined"] == r0["dist_solves"], (r0, r1)
    assert r1["dist_solves"] == r0["dist_solves"]

    # trajectory parity with a one-process run (dense solves)
    from rgbdslam_tpu_torch.eval.ate import ate_rmse
    from rgbdslam_tpu_torch.parallel.mp_slam import _make_config, run_tracking

    cfg = dataclasses.replace(_make_config(), distributed=False)
    system, ds, _ = run_tracking(cfg, "orbit", FRAMES, "cpu")
    ts_s, poses_s = system.camera_trajectory()
    rmse_s, _ = ate_rmse(ts_s, poses_s, ds.timestamps[:FRAMES], ds.poses_twc[:FRAMES])
    assert rmse_s < 0.10
    poses_mp = np.load(traj_out)["poses_twc"]
    assert poses_mp.shape == poses_s.shape
    diff = np.linalg.norm(poses_mp[:, :3, 3] - poses_s[:, :3, 3], axis=-1)
    assert float(diff.max()) < 0.05, f"2-process vs one-process divergence {diff.max():.3f} m"
