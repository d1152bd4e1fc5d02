"""The JAX suite's behaviour tests on the card (the counterparts of
tests/test_torch_loop_recall.py and tests/test_torch_behaviour.py), each
run through the kernels with every plain version made to raise and held to
its JAX test's own bounds. Every test here is marked `gpu` and skips
without a card:

  python -m pytest --noconftest -m gpu tests/test_torch_gpu_behaviour.py

- recall@5 and precision of loop retrieval (both detections through
  kernels A and B or A and C, K2 in the verification-free BoW path);
- growth past every budget at cells of 6 (kernels A and B, the fused
  RANSAC, K4, the backend's batched verification);
- the relocalization boundary through the real verification (the batched
  match and the fused RANSAC of the bank keyframes);
- the second-reference retry; ORB's survival of a dolly and a roll (kernels
  A and C, the fused RANSAC); the ADAPTIVE detector's within-frame retry
  (the threshold from device memory); the multi-room loop closure.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pb(dev):
    import port_behaviour

    return port_behaviour


@pytest.fixture
def counts(dev):
    from rgbdslam_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    return kernels.LAUNCHES


@pytest.mark.parametrize("detector,vocname,wrapper", [
    ("svo_fast", "voc_synth_fast_brief.npz", "detect_keypoints_fused"),
    ("orb", "voc_synth_orb.npz", "detect_keypoints_scaled"),
])
def test_retrieval_recall_on_the_card(dev, pb, counts, detector, vocname, wrapper):
    with pb.plain_versions_forbidden():
        r = pb.retrieval_recall(detector, vocname, dev)
    assert counts[wrapper] == 160 and counts["detect_score_map"] == 0
    assert r["queries"] >= 60 and r["recall"] >= 0.75 and r["precision"] >= 0.60, r


def test_growth_on_the_card(dev, pb, counts):
    with pb.plain_versions_forbidden():
        g, out = pb.pose_graph_growth(dev)
        system, rmse = pb.growth_run(dev)
    assert g.n_vertices == 30 and g.n_edges == 53 and np.isfinite(out).all()
    k = system.store.count
    assert k > 4 and system.store.max_keyframes >= k and system.graph.max_vertices >= k
    assert system.graph.n_vertices == k and system.graph.n_edges > 8
    assert system.loop_detector.bow_db.shape[0] >= k and system._bank[0].shape[0] >= k
    assert system.landmarks.count > 512
    assert rmse < 0.25, f"growth run ATE {rmse:.3f}"
    assert counts["detect_keypoints_fused"] == 40 and counts["ransac_se3_fused"] > 0


def test_reloc_boundary_on_the_card(dev, pb, counts):
    with pb.plain_versions_forbidden():
        ok_below, ok_at, Tcw, expect = pb.reloc_boundary_stubbed(dev)
        n, ok_n, ok_n1, Tcw_n, expect_n = pb.reloc_boundary_verified(dev)
    assert not ok_below and ok_at
    np.testing.assert_allclose(Tcw, expect, atol=1e-6)
    assert n > 0 and ok_n and not ok_n1
    np.testing.assert_allclose(Tcw_n, expect_n, atol=1e-6)
    assert counts["ransac_se3_fused"] > 0


def test_second_reference_retry_on_the_card(dev, pb, counts):
    with pb.plain_versions_forbidden():
        failures, rmse = pb.second_reference_retry(dev)
    assert failures <= 2 and rmse < 0.2, (failures, rmse)
    assert counts["detect_keypoints_fused"] == 20


@pytest.mark.parametrize("advance,roll", [(0.75, 0.0), (0.5, 0.35)])
def test_orb_dolly_roll_on_the_card(dev, pb, counts, advance, roll):
    with pb.plain_versions_forbidden():
        res_orb, n_orb, res_svo, T21_gt = pb.dolly_roll(advance, roll, dev)
    assert bool(res_orb.success), f"orb RANSAC failed ({n_orb} matches)"
    T = res_orb.T21.cpu().numpy()
    assert np.linalg.norm(T[:3, 3] - T21_gt[:3, 3]) < 0.05
    ang = np.arccos(np.clip((np.trace(T[:3, :3].T @ T21_gt[:3, :3]) - 1) / 2, -1, 1))
    assert ang < 0.05
    assert int(res_orb.num_inliers) > int(res_svo.num_inliers)
    assert counts["detect_keypoints_scaled"] == 2 and counts["ransac_se3_fused"] == 2


def test_adaptive_recovers_within_frame_on_the_card(dev, pb, counts):
    with pb.plain_versions_forbidden():
        n_oneshot, n_after = pb.adaptive_scene_change(dev)
    assert n_oneshot < 30 and n_after >= 60, (n_oneshot, n_after)
    assert counts["detect_keypoints_fused"] >= 3      # the retries re-detect


def test_multiroom_closes_loop_on_the_card(dev, pb, counts):
    with pb.plain_versions_forbidden():
        system, rmse = pb.multiroom_run(dev)
    assert system.tracker.stats.failures <= 96 * 0.15
    assert system.store.count >= 15 and rmse < 0.15, (system.store.count, rmse)
    assert system.graph.n_edges > system.graph.n_vertices - 1
    assert counts["detect_keypoints_fused"] == 96
