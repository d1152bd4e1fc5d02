"""The distributed backend of rgbdslam_tpu_torch with the batched tracker
and with global BA (the counterparts of tests/test_distributed_system.py::
test_distributed_composes_with_batched_tracking and
::test_global_ba_rides_the_mesh), on 8 virtual CPU shards at 160x120
(tests/test_torch_distributed_system.py gives the configuration and why
the scale), held to the JAX tests' bounds.
"""

import numpy as np
import pytest
import torch
from test_torch_distributed_system import CAM, SHARDS, run_slam, slam_cfg

from rgbdslam_tpu_torch.device import virtual_devices
from rgbdslam_tpu_torch.eval.ate import ate_rmse
from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
from rgbdslam_tpu_torch.parallel import dist_ba
from rgbdslam_tpu_torch.slam.system import SlamSystem


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_distributed_composes_with_batched_tracking():
    """--distributed + --batch: the batched tracker feeds the mesh-routed
    backend; the final optimize rides the mesh."""
    n, B = 48, 8
    ds = SyntheticDataset(n_frames=n, cam=CAM, trajectory="orbit", loops=1.15, device="cpu")
    with virtual_devices(SHARDS):
        system = SlamSystem(CAM, slam_cfg(distributed=True), seed=0, device="cpu")
        for i in range(0, n, B):
            items = [ds.grab(j) for j in range(i, min(i + B, n))]
            system.track_batch(*zip(*items))
        system.finish()
    assert system._mesh is not None and system._mesh.size == SHARDS
    assert system.graph.dist_solves >= 1
    ts_c, poses_c = system.camera_trajectory()
    assert np.all(np.isfinite(poses_c))
    rmse, _ = ate_rmse(ts_c, poses_c, ds.timestamps[:n], ds.poses_twc[:n])
    assert rmse < 0.15, f"batched+distributed ATE {rmse:.3f}"


def test_global_ba_rides_the_mesh(monkeypatch):
    """With use_global_ba the post-loop and final polishes dispatch to the
    landmark-sharded distributed_local_ba (with the graph's edge factors)
    and keep the trajectory accurate."""
    calls = []
    real = dist_ba.distributed_local_ba

    def spy(cam, problem, fixed_kf, mesh, *a, **k):
        calls.append((mesh.size, k.get("edges") is not None))
        return real(cam, problem, fixed_kf, mesh, *a, **k)

    monkeypatch.setattr(dist_ba, "distributed_local_ba", spy)
    sys_d, _poses, rmse = run_slam(slam_cfg(distributed=True, global_ba=True))
    assert sys_d.loops_closed >= 1
    assert sys_d.graph.dist_solves >= 1
    assert calls and calls == [(SHARDS, True)] * len(sys_d.global_ba_ms)
    assert rmse < 0.10, f"distributed global-BA ATE {rmse:.3f}"
