"""The other extractor families of rgbdslam_tpu_torch through every
tracking mode (port only, 160x120): serial SlamSystem.track, the ring
(track_pipelined, equal to serial) and batches of 8 (track_batch) for gftt,
star, brisk, freak, latch and surf; and ROADMAP fault F1's replay of the two
keyframe gates under a rigid change of the world frame.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, RansacConfig, SlamConfig
from rgbdslam_tpu_torch.eval.ate import ate_rmse
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset, tour_trajectory
from rgbdslam_tpu_torch.slam.system import SlamSystem
from rgbdslam_tpu_torch.slam.tracking import Tracker, keyframe_gate
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM = Camera(fx=100.0, fy=100.0, cx=79.5, cy=59.5, width=160, height=120)
# 64 RANSAC hypotheses (256 by default): most of a run's CPU time at this size
CFG = SlamConfig(extractor=ExtractorConfig(num_features=256, cell_size=8, fast_threshold=15.0),
                 loop=LoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=64),
                 ransac=RansacConfig(num_hypotheses=64))
N_FRAMES, B = 8, 8


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticDataset(n_frames=128, cam=CAM, trajectory="tour", loops=1.15, device="cpu")
    return ds, [ds.grab(i) for i in range(N_FRAMES)]


def _run(detector, fr, mode):
    system = SlamSystem(CAM, dataclasses.replace(CFG, detector=detector), seed=0, device="cpu")
    if mode == "serial":
        for ts, g, d in fr:
            system.track(ts, g, d)
    elif mode == "ring":
        for ts, g, d in fr:
            system.track_pipelined(ts, g, d)
        system.track_pipelined_flush()
    else:
        for i in range(0, len(fr), B):
            system.track_batch(*zip(*fr[i:i + B]))
    system.finish()
    return system


@pytest.mark.parametrize("detector", ["gftt", "star", "brisk", "freak", "latch", "surf"])
def test_family_runs_in_every_mode(frames, detector):
    """Serial: ATE < 0.05 m, no failed frame, keyframe descriptors of the
    family's type; the ring equal to serial (poses within 1e-6, the same
    keyframes); batches of 8: ATE < 0.05 m, finite, keyframes within 20 % + 1
    of serial's."""
    ds, fr = frames
    runs = {mode: _run(detector, fr, mode) for mode in ("serial", "ring", "batch")}
    ser = runs["serial"]
    for mode, system in runs.items():
        ts, poses = system.camera_trajectory()
        rmse, info = ate_rmse(ts, poses, ds.timestamps[:N_FRAMES], ds.poses_twc[:N_FRAMES])
        assert info["pairs"] == N_FRAMES and np.isfinite(poses).all(), mode
        assert rmse < 0.05, (mode, rmse)
        assert system.tracker.stats.failures == 0, mode
    assert ser._bank[0].dtype == (torch.float32 if detector == "surf" else torch.int32)
    np.testing.assert_allclose(runs["ring"].camera_trajectory()[1], ser.camera_trajectory()[1],
                               rtol=0, atol=1e-6)
    assert runs["ring"].store.count == ser.store.count
    assert abs(runs["batch"].store.count - ser.store.count) <= 0.2 * ser.store.count + 1


def test_keyframe_gates_under_a_rigid_world_change():
    """ROADMAP F1: replay the host gate (Tracker._need_keyframe, the serial
    and ring modes) and the device gate (keyframe_gate, batches) over the
    tour's 128 poses (the ground truth the serial runs track to ~1 cm),
    then over the same motion in another world frame, Tcw' = Tcw G. The
    device gate measures the motion itself and picks the same keyframes; the
    host gate's translation inverse(Tcw) Tcw_kf depends on where the world
    origin lies, and its picks change."""
    poses_twc = tour_trajectory(128, loops=1.15)
    Tcw = np.stack([se3.inverse_np(T) for T in poses_twc]).astype(np.float64)
    G = np.eye(4)
    c, s = np.cos(0.6), np.sin(0.6)
    G[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    G[:3, 3] = [3.0, -2.0, 5.0]
    tracker = Tracker(CAM, CFG, device="cpu")

    def host_picks(P):
        tracker.last_kf_Tcw = P[0]
        picks = [0]
        for i in range(1, len(P)):
            if tracker._need_keyframe(P[i]):
                tracker.last_kf_Tcw = P[i]
                picks.append(i)
        return picks

    def device_picks(P):
        D = torch.eye(4, dtype=torch.float64)
        picks = [0]
        for i in range(1, len(P)):
            T21 = torch.as_tensor(P[i] @ se3.inverse_np(P[i - 1]))
            kf, D = keyframe_gate(T21, torch.tensor(True), D, CFG.keyframe)
            if bool(kf):
                picks.append(i)
        return picks

    moved = Tcw @ G
    dev0, dev1 = device_picks(Tcw), device_picks(moved)
    host0, host1 = host_picks(Tcw), host_picks(moved)
    assert dev0 == dev1
    assert host0 != host1
    assert len(host0) > len(dev0)       # the serial runs' 117 against 84 (PERF.md)


@pytest.mark.parametrize("detector", ["orb"])
def test_cli_detector_choices_and_vocabulary(tmp_path, capsys, detector):
    """The CLI takes the JAX CLI's twelve --detector choices and, without
    --vocabulary, loads the shipped vocabulary of the family as the JAX CLI
    does (orb: voc_synth_orb.npz; the families without one train online,
    tests/test_torch_families_float.py); a short batched run on the CPU."""
    import json

    from rgbdslam_tpu import cli as jcli
    from rgbdslam_tpu_torch import cli

    def choices(parser):
        return next(a.choices for a in parser._actions if a.dest == "detector")

    assert choices(cli.build_argparser()) == choices(jcli.build_argparser())
    assert cli.main(["--dataset", "synthetic:sweep", "--frames", "16", "--device", "cpu",
                     "--width", "160", "--height", "120", "--cell-size", "8",
                     "--num-features", "256", "--fast-threshold", "15", "--batch", "8",
                     "--detector", detector, "--out-dir", str(tmp_path)]) == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert out["frames"] == 16 and out["failures"] == 0 and out["ate_rmse"] < 0.05
    assert ("voc_synth_orb.npz" in captured.err) == (detector == "orb")
