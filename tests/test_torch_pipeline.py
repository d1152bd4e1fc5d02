"""The tracking slice: rgbdslam_tpu_torch's PipelinedOdometry against
rgbdslam_tpu's on the same rendered 24-frame 320x240 sweep, plus the CLI.

RANSAC samples differ (jax.random vs torch.Generator), so the trajectories
are compared by what they estimate: both ATEs under the 0.05 m bound of
tests/test_odometry.py, and within 0.01 m of each other (across RANSAC
seeds the sweep's ATE moves by a few mm).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbdslam_tpu.config import ExtractorConfig as JExtractorConfig
from rgbdslam_tpu.config import SlamConfig as JSlamConfig
from rgbdslam_tpu.eval.ate import ate_rmse as j_ate
from rgbdslam_tpu.frontend.frame import build_frame_features as j_build
from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.io.synthetic import SyntheticDataset
from rgbdslam_tpu.slam.pipeline import PipelinedOdometry as JPipe
from rgbdslam_tpu_torch import cli
from rgbdslam_tpu_torch.convert import config_from_jax, frame_features_from_numpy
from rgbdslam_tpu_torch.eval.ate import ate_rmse
from rgbdslam_tpu_torch.geometry.camera import Camera as TCamera
from rgbdslam_tpu_torch.ops import kernels
from rgbdslam_tpu_torch.slam.pipeline import PipelinedOdometry
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM_ARGS = dict(fx=200.0, fy=200.0, cx=159.5, cy=119.5, width=320, height=240)
JCFG = JSlamConfig(extractor=JExtractorConfig(num_features=1024, num_levels=3, cell_size=8,
                                              fast_threshold=15.0))


@pytest.fixture(scope="module")
def runs():
    ds = SyntheticDataset(n_frames=24, cam=JCamera(**CAM_ARGS), trajectory="sweep")
    frames = [(ts, np.asarray(g), np.asarray(d)) for ts, g, d in
              (ds.grab(i) for i in range(len(ds)))]
    ts_j, poses_j, st_j = JPipe(JCamera(**CAM_ARGS), JCFG, batch=8).run(frames)
    # the first frame's features cross from the JAX package through convert.py
    fj = j_build(JCamera(**CAM_ARGS), jnp.asarray(frames[0][1]), jnp.asarray(frames[0][2]),
                 JCFG.extractor)
    f_ref = frame_features_from_numpy({k: np.asarray(getattr(fj, k))
                                       for k in fj.__dataclass_fields__}, device="cpu")
    kernels.reset_launch_counts()
    odo = PipelinedOdometry(TCamera(**CAM_ARGS), config_from_jax(JCFG), batch=8, seed=0,
                            device="cpu")
    ts_t, poses_t, st_t = odo.run(frames, f_ref=f_ref)
    return ds, (ts_j, poses_j, st_j), (ts_t, poses_t, st_t), dict(kernels.LAUNCHES)


def test_slice_ate_matches_jax(runs):
    ds, (ts_j, poses_j, st_j), (ts_t, poses_t, st_t), _ = runs
    ate_j, _ = j_ate(ts_j, poses_j, ds.timestamps, ds.poses_twc)
    ate_t, info = ate_rmse(ts_t, poses_t, ds.timestamps, ds.poses_twc)
    assert info["pairs"] == len(ds)
    assert ate_j < 0.05 and ate_t < 0.05, (ate_j, ate_t)
    assert abs(ate_t - ate_j) < 0.01, (ate_j, ate_t)


def test_slice_stats_and_frame_motion_match_jax(runs):
    _, (ts_j, poses_j, st_j), (ts_t, poses_t, st_t), launches = runs
    np.testing.assert_array_equal(ts_t, ts_j)
    assert st_t["frames"] == st_j["frames"] == 24
    assert st_t["failures"] == st_j["failures"] == 0
    # mean inliers of two RANSACs on the same matches: within 10 %
    assert abs(st_t["mean_inliers"] - st_j["mean_inliers"]) <= 0.1 * st_j["mean_inliers"]
    # frame-to-frame motion: same estimates up to the RANSAC sampling noise
    rel = lambda P: np.linalg.inv(P[:-1]) @ P[1:]
    dt = np.linalg.norm(rel(poses_t)[:, :3, 3] - rel(poses_j)[:, :3, 3], axis=-1)
    assert dt.max() < 0.02, dt.max()
    # CPU tensors take the plain versions: no kernel launched
    assert all(v == 0 for v in launches.values()), launches


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelinedOdometry(TCamera(**CAM_ARGS), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--dataset", "synthetic:sweep", "--frames", "3", "--pipelined", "2",
                  "--device", "cuda"])


def test_cli_rejects_unported_modes(monkeypatch, capsys):
    # full SLAM, serial odometry (tests/test_torch_system.py), the batched
    # and ring modes (below), disk datasets and the exports
    # (tests/test_torch_disk_slam.py), dense ICP and bundle adjustment
    # (tests/test_torch_accuracy_slam.py) run since they were ported, and
    # --distributed on one device (tests/test_torch_distributed_flag.py);
    # the distributed backend across several CUDA devices (ported) names
    # its mesh over both cards before the loader starts, with any other flag
    from rgbdslam_tpu_torch.io import datasets

    class LoaderReached(Exception):
        pass

    def loader(*a, **k):
        raise LoaderReached

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(datasets, "open_dataset", loader)
    for argv in (["--dataset", "synthetic:sweep", "--distributed"],
                 ["--dataset", "synthetic:sweep", "--dense-icp", "--distributed", "--plot"],
                 ["--dataset", "/data/tum", "--global-ba", "--distributed"]):
        with pytest.raises(LoaderReached):
            cli.main(argv + ["--device", "cuda"])
        err = capsys.readouterr().err
        assert "distributed: Mesh(edges: 2 shards" in err and "cuda:0, cuda:1" in err, err


def test_cli_pipelined_runs_on_cpu(tmp_path, capsys):
    assert cli.main(["--dataset", "synthetic:sweep", "--frames", "3", "--pipelined", "2",
                     "--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == 3 and out["device"] == "cpu"
    assert np.isfinite(out["ate_rmse"])
    with open(os.path.join(tmp_path, "CameraTrajectory.txt")) as f:
        assert len(f.read().splitlines()) == 3


@pytest.mark.parametrize("mode", [["--batch", "8"], ["--ring"],
                                  ["--batch", "8", "--odometry-only"],
                                  ["--ring", "--odometry-only"]])
def test_cli_batch_and_ring_run_on_cpu(tmp_path, capsys, mode):
    """The batched and ring modes through the CLI, full SLAM and the bare
    tracker, at 320x240 on the 24-frame sweep: one JSON line as in serial
    mode, both trajectory files, every frame tracked."""
    assert cli.main(["--dataset", "synthetic:sweep", "--frames", "24", "--device", "cpu",
                     "--width", "320", "--height", "240", "--cell-size", "8",
                     "--fast-threshold", "15", "--out-dir", str(tmp_path)] + mode) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["frames"] == 24 and out["ate_pairs"] == 24 and out["failures"] == 0
    assert out["ate_rmse"] < 0.05 and out["keyframes"] >= 2
    assert ("loops_closed" in out) == ("--odometry-only" not in mode)
    with open(os.path.join(tmp_path, "CameraTrajectory.txt")) as f:
        assert len(f.read().splitlines()) == 24
    with open(os.path.join(tmp_path, "KeyFrameTrajectory.txt")) as f:
        assert len(f.read().splitlines()) == out["keyframes"]
