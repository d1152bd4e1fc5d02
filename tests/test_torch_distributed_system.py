"""System-level distributed backend of rgbdslam_tpu_torch (the counterpart
of tests/test_distributed_system.py::
test_full_slam_distributed_matches_single_device; the batched and global-BA
cases are tests/test_torch_distributed_modes.py, the degrade on one device
tests/test_torch_distributed_flag.py).

A full SLAM run with SlamConfig.distributed on 8 virtual CPU shards
(device.virtual_devices, the counterpart of the JAX suite's 8 virtual host
devices) must route every pose-graph solve through the edge-sharded CG LM
(PoseGraph.dist_solves), close the loop and match the plain run's
trajectory within the JAX test's bounds (ATE < 0.10 m, poses within 0.05 m:
the two differ only by the dense solve against the distributed CG).

Scale: tests/test_distributed_system.py's configuration and 80-frame orbit
(loops=1.15, whose revisit the loop closes) at 160x120 with 512 features
instead of 320x240 and 1,024: the loop still closes, in a quarter of the
pixels.
"""

import numpy as np

from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, SlamConfig
from rgbdslam_tpu_torch.device import virtual_devices
from rgbdslam_tpu_torch.eval.ate import ate_rmse
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
from rgbdslam_tpu_torch.parallel import Mesh
from rgbdslam_tpu_torch.slam.system import SlamSystem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM = Camera(100.0, 100.0, 79.5, 59.5, width=160, height=120)
SHARDS = 8


def slam_cfg(distributed: bool, global_ba: bool = False) -> SlamConfig:
    return SlamConfig(
        extractor=ExtractorConfig(num_features=512, num_levels=3, cell_size=8,
                                  fast_threshold=15.0),
        loop=LoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=256),
        distributed=distributed, use_global_ba=global_ba)


def run_slam(cfg: SlamConfig, n: int = 80):
    ds = SyntheticDataset(n_frames=n, cam=CAM, trajectory="orbit", loops=1.15, device="cpu")
    with virtual_devices(SHARDS):
        system = SlamSystem(CAM, cfg, seed=0, device="cpu")
        for i in range(n):
            system.track(*ds.grab(i))
        system.finish()
    ts_c, poses_c = system.camera_trajectory()
    rmse, _ = ate_rmse(ts_c, poses_c, ds.timestamps[:n], ds.poses_twc[:n])
    return system, poses_c, rmse


def test_full_slam_distributed_matches_single_device():
    sys_s, poses_s, rmse_s = run_slam(slam_cfg(distributed=False))
    sys_d, poses_d, rmse_d = run_slam(slam_cfg(distributed=True))

    # the distributed run rode the mesh, for every solve
    assert isinstance(sys_d._mesh, Mesh) and sys_d._mesh.size == SHARDS
    assert sys_d.graph.mesh is sys_d._mesh
    assert sys_d.graph.dist_solves >= 1
    assert sys_s._mesh is None and sys_s.graph.dist_solves == 0
    # one mid-run loop solve and the final one, each on the mesh
    assert sys_d.graph.dist_solves == len(sys_d.loop_solve_ms) + 1
    # the same SLAM outcome: loop closed, accuracy kept
    assert sys_d.loops_closed >= 1
    assert rmse_s < 0.10 and rmse_d < 0.10
    assert sys_d.store.count == sys_s.store.count
    diff = np.linalg.norm(poses_d[:, :3, 3] - poses_s[:, :3, 3], axis=-1)
    assert float(diff.max()) < 0.05, f"max pose divergence {diff.max():.3f}"
