"""The JAX suite's behaviour tests that no parity test of the port pinned,
on the PyTorch port alone on the CPU, each held to its JAX test's own
bounds (the JAX tests pin the JAX package's side; nothing here runs JAX):

- tests/test_growth.py: every store doubles past its budget;
- tests/test_reloc_batch.py::test_reloc_acceptance_at_min_inliers_boundary,
  as written (stubbed verification) and through the real verification;
- tests/test_landmarks.py::test_full_track_replacement_keeps_widest_baselines;
- tests/test_robustness.py::test_second_reference_retry;
- tests/test_orb_scale.py::test_orb_pyramid_survives_dolly_roll;
- tests/test_extractor_cli.py::test_adaptive_recovers_within_frame_on_scene_change;
- tests/test_multiroom.py::test_multiroom_slam_closes_loop.

The runs themselves live in tests/port_behaviour.py, which
tests/test_torch_gpu_behaviour.py drives on the card.
"""

import numpy as np
import pytest

import port_behaviour as pb
from rgbdslam_tpu_torch.mapping.landmarks import LandmarkStore
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_pose_graph_grows_past_budgets():
    g, out = pb.pose_graph_growth("cpu")
    assert g.n_vertices == 30 and g.max_vertices >= 30
    assert g.n_edges == 29 + 24 and g.max_edges >= g.n_edges
    assert out.shape == (30, 4, 4)
    assert np.isfinite(out).all()


def test_full_system_grows_past_every_budget():
    system, rmse = pb.growth_run("cpu")
    k = system.store.count
    assert k > 4, "gate too strict: the test needs many keyframes"
    assert system.store.max_keyframes >= k
    assert system.graph.n_vertices == k
    assert system.graph.max_vertices >= k
    assert system.graph.n_edges > 8
    assert system.loop_detector.bow_db.shape[0] >= k
    assert system._bank[0].shape[0] >= k
    assert system.landmarks.count > 512
    assert rmse < 0.25, f"growth run ATE {rmse:.3f}"


def test_reloc_acceptance_at_min_inliers_boundary():
    ok_below, ok_at, Tcw, expect = pb.reloc_boundary_stubbed("cpu")
    assert not ok_below, "accepted a candidate below reloc_min_inliers"
    assert ok_at, "rejected a candidate at exactly reloc_min_inliers"
    np.testing.assert_allclose(Tcw, expect, atol=1e-6)


def test_reloc_boundary_through_the_real_verification():
    n, ok_at, ok_above, Tcw, expect = pb.reloc_boundary_verified("cpu")
    assert n > 0
    assert ok_at, f"rejected the best candidate at exactly its {n} inliers"
    assert not ok_above, f"accepted {n} inliers with reloc_min_inliers {n + 1}"
    np.testing.assert_allclose(Tcw, expect, atol=1e-6)


def test_full_track_replacement_keeps_widest_baselines():
    """A full track (M observations) replaces its least baseline-diverse
    view with a new one; without keyframe centers it drops the new one."""
    M = 4
    store = LandmarkStore(max_landmarks=8, max_obs=M, num_features=2)
    uv = np.zeros((2, 2), np.float32)
    xyz = np.tile(np.array([0.0, 0.0, 2.0], np.float32), (2, 1))
    ok = np.array([True, False])
    desc = np.zeros((2, 8), np.uint32)
    inten = np.zeros(2, np.float32)
    T = np.eye(4, dtype=np.float32)
    centers = np.zeros((8, 3), np.float32)
    centers[:4, 0] = np.arange(4) * 0.01
    centers[4, 0] = 1.0
    centers[5, 0] = 2.0
    lm = store.add_keyframe(0, uv, xyz, ok, desc, inten, T)[0]
    ext = (np.array([0, 0], np.int32), np.array([True, False]))
    for kf in range(1, 4):
        store.add_keyframe(kf, uv, xyz, ok, desc, inten, T, ext[0], ext[1],
                           prev_kf=kf - 1, kf_centers=centers)
    assert store.obs_count[lm] == M
    store.add_keyframe(4, uv, xyz, ok, desc, inten, T, ext[0], ext[1], prev_kf=3,
                       kf_centers=centers)
    kfs = set(store.obs_kf[lm][store.obs_valid[lm]])
    assert 4 in kfs, f"wide-baseline obs not retained: {kfs}"
    assert store.obs_replaced == 1 and store.obs_dropped == 0
    store.add_keyframe(5, uv, xyz, ok, desc, inten, T, ext[0], ext[1], prev_kf=4,
                       kf_centers=centers)
    assert {4, 5} <= set(store.obs_kf[lm][store.obs_valid[lm]])
    assert store.obs_replaced == 2
    store2 = LandmarkStore(max_landmarks=8, max_obs=2, num_features=2)
    store2.add_keyframe(0, uv, xyz, ok, desc, inten, T)
    store2.add_keyframe(1, uv, xyz, ok, desc, inten, T, ext[0], ext[1], prev_kf=0)
    store2.add_keyframe(2, uv, xyz, ok, desc, inten, T, ext[0], ext[1], prev_kf=1)
    assert store2.obs_dropped == 1


def test_second_reference_retry():
    failures, rmse = pb.second_reference_retry("cpu")
    assert failures <= 2
    assert rmse < 0.2


@pytest.mark.parametrize("advance,roll", [(0.75, 0.0), (0.5, 0.35)])
def test_orb_pyramid_survives_dolly_roll(advance, roll):
    res_orb, n_orb, res_svo, T21_gt = pb.dolly_roll(advance, roll, "cpu")
    assert bool(res_orb.success), f"orb RANSAC failed ({n_orb} matches)"
    T = res_orb.T21.cpu().numpy()
    assert np.linalg.norm(T[:3, 3] - T21_gt[:3, 3]) < 0.05
    ang = np.arccos(np.clip((np.trace(T[:3, :3].T @ T21_gt[:3, :3]) - 1) / 2, -1, 1))
    assert ang < 0.05
    assert int(res_orb.num_inliers) > int(res_svo.num_inliers), (
        f"orb {int(res_orb.num_inliers)} <= svo {int(res_svo.num_inliers)}")


def test_adaptive_recovers_within_frame_on_scene_change():
    n_oneshot, n_after = pb.adaptive_scene_change("cpu")
    assert n_oneshot < 30, f"scene not hard enough ({n_oneshot})"
    assert n_after >= 60, f"within-frame retry failed to recover ({n_after})"


def test_multiroom_slam_closes_loop():
    system, rmse = pb.multiroom_run("cpu")
    assert system.tracker.stats.failures <= 96 * 0.15
    assert system.store.count >= 15
    assert rmse < 0.15, f"multi-room ATE {rmse:.3f}"
    assert system.graph.n_edges > system.graph.n_vertices - 1
