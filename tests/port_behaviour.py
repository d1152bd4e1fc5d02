"""The JAX suite's behaviour tests, run on the PyTorch port alone, on either
device: tests/test_torch_loop_recall.py and tests/test_torch_behaviour.py
call them on the CPU (the plain versions), tests/test_torch_gpu_behaviour.py
on the card with every plain version made to raise. Each function drives the
port as its JAX test drives the JAX package and returns what that test
asserts on; the bounds stay in the test files, the JAX tests' own.

This module imports torch and the port only (the card's machine has no JAX).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from rgbdslam_tpu_torch.config import (ExtractorConfig, KeyframeConfig, LoopConfig,
                                       PoseGraphConfig, RansacConfig, SlamConfig)
from rgbdslam_tpu_torch.eval.ate import ate_rmse
from rgbdslam_tpu_torch.frontend.extractor import Extractor
from rgbdslam_tpu_torch.frontend.matcher import correspondence_weights, match_descriptors
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.io.synthetic import (SyntheticDataset, look_at_pose,
                                             orbit_trajectory, render_frame)
from rgbdslam_tpu_torch.loop.detector import LoopDetector
from rgbdslam_tpu_torch.slam.system import SlamSystem
from rgbdslam_tpu_torch.slam.tracking import Tracker
from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraph
from rgbdslam_tpu_torch.solvers.ransac_se3 import ransac_se3

ASSETS = os.path.join(os.path.dirname(__file__), "..", "rgbdslam_tpu_torch", "assets")
CAM320 = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
CAM160 = Camera(130.0, 130.0, 79.5, 59.5, width=160, height=120)


@contextlib.contextmanager
def plain_versions_forbidden():
    """Every plain version of a kernel raises inside the block (the card's
    runs must go through the kernels alone; chip_smoke.py's list)."""
    from rgbdslam_tpu_torch.ops import fast, kernels
    from rgbdslam_tpu_torch.solvers import icp
    from rgbdslam_tpu_torch.solvers import ransac_se3 as ransac_mod

    names = [(kernels, n) for n in (
        "detect_score_map_ref", "hamming_match_2nn_ref", "match_gates_ref", "match_gated_ref",
        "mahal_hypothesis_scores_ref", "gicp_refine_ref", "gicp_gn_normal_equations_ref")]
    names += [(fast, n) for n in ("detect_keypoints_ref", "detect_cells_ref",
                                  "detect_select_ref", "detect_keypoints_scaled_ref",
                                  "detect_scaled_cells_ref")]
    names += [(icp, n) for n in ("_finish_gicp", "nearest_targets")]
    names += [(ransac_mod, n) for n in ("ransac_se3_ref", "hypotheses_ref",
                                        "hypothesis_fits_ref", "select_refine_ref",
                                        "refine_mahalanobis_ref", "pair_errors")]
    saved = [(mod, n, getattr(mod, n)) for mod, n in names]

    def forbid(name):
        def f(*a, **k):
            raise AssertionError(f"plain version {name} ran for CUDA tensors")
        return f

    try:
        for mod, n in names:
            setattr(mod, n, forbid(n))
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


# ---------------------------------------------------------------------------
# tests/test_loop_recall.py:32-101
# ---------------------------------------------------------------------------


def retrieval_recall(detector: str, vocname: str, device) -> dict:
    """A 160-keyframe, 3.2-revolution orbit at 320x240, each keyframe
    described by `detector` and quantized against the shipped vocabulary,
    scored through the LoopDetector's gates (min-connected-score floor,
    id-interval gap, top 5): the revisit queries, recall@5 and precision
    (tests/test_loop_recall.py's ground truth and counting)."""
    K, id_interval = 160, 25
    poses = orbit_trajectory(K, loops=3.2)
    centers = poses[:, :3, 3]
    dirs = poses[:, :3, 2]
    cfg = LoopConfig(id_interval=id_interval, vocab_size=4096)
    ld = LoopDetector(cfg, max_keyframes=K + 2, device=device)
    ld.load_vocabulary(os.path.join(ASSETS, vocname))
    assert ld.words is not None and ld.idf.shape[0] == 4096
    ex = Extractor(CAM320, ExtractorConfig(num_features=512, num_levels=3, cell_size=8,
                                           fast_threshold=15.0), detector=detector)
    for k in range(K):
        gray, depth = render_frame(CAM320, poses[k], device=device)
        f = ex(gray, depth)
        conn = {k - 1} if k > 0 else set()
        for j in range(max(0, k - id_interval), k):
            if np.linalg.norm(centers[j] - centers[k]) < 0.5:
                conn.add(j)
        ld.add(f.desc.cpu().numpy().view(np.uint32), f.obs_valid.cpu().numpy(), conn)

    def gt_set(k):
        return [j for j in range(K) if abs(j - k) > id_interval
                and np.linalg.norm(centers[j] - centers[k]) <= 0.35
                and np.dot(dirs[j], dirs[k]) >= np.cos(np.deg2rad(30))]

    queries = hits = returned = correct = 0
    for k in range(K):
        gt = gt_set(k)
        if not gt:
            continue
        cand = ld.candidates(k)
        queries += 1
        hits += int(any(c in gt for c in cand))
        for c in cand:
            returned += 1
            correct += int(np.linalg.norm(centers[c] - centers[k]) < 0.6
                           and np.dot(dirs[c], dirs[k]) > np.cos(np.deg2rad(45)))
    return {"queries": queries, "recall": hits / max(queries, 1),
            "precision": correct / max(returned, 1), "returned": returned}


# ---------------------------------------------------------------------------
# tests/test_growth.py
# ---------------------------------------------------------------------------


def pose_graph_growth(device):
    """tests/test_growth.py:22: 30 vertices and 53 edges into budgets of 8
    and 4, then three LM iterations; returns the graph and the solve."""
    g = PoseGraph(max_vertices=8, max_edges=4, device=device)
    rng = np.random.default_rng(0)
    for k in range(30):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = rng.normal(0, 0.1, 3).astype(np.float32) + [k * 0.1, 0, 0]
        g.add_vertex(T)
        if k > 0:
            g.add_odometry_edge(k, k - 1)
        if k > 5:
            g.add_edge(k, k - 3, np.eye(4, dtype=np.float32), weight=0.5)
    return g, np.asarray(g.optimize(3))


def growth_run(device):
    """tests/test_growth.py:40-80: 40 tour frames at 160x120 (cells of 6)
    through SlamSystem with budgets of 4 keyframes, 8 edges, 512 landmarks
    and a 4-row BoW table. Returns (system, ATE)."""
    cfg = SlamConfig(
        extractor=ExtractorConfig(num_features=256, num_levels=3, cell_size=6,
                                  fast_threshold=12.0, min_response=8.0, min_border=16),
        keyframe=KeyframeConfig(min_translation=0.02, min_rotation=0.02, max_keyframes=4),
        pose_graph=PoseGraphConfig(max_edges=8),
        loop=LoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=128),
        max_landmarks=512,
    )
    n = 40
    ds = SyntheticDataset(n_frames=n, cam=CAM160, trajectory="tour", loops=0.35,
                          device=device)
    system = SlamSystem(CAM160, cfg, seed=0, device=device)
    system.loop_detector.bow_db = system.loop_detector.bow_db[:4].copy()
    for i in range(n):
        system.track(*ds.grab(i))
    system.finish()
    ts_c, poses_c = system.camera_trajectory()
    return system, ate_rmse(ts_c, poses_c, ds.timestamps, ds.poses_twc)[0]


# ---------------------------------------------------------------------------
# tests/test_reloc_batch.py:91
# ---------------------------------------------------------------------------

RELOC_CFG = SlamConfig(
    extractor=ExtractorConfig(num_features=512, num_levels=3, cell_size=8, fast_threshold=15.0),
    loop=LoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=256),
    lost_after=2,
)


def reloc_boundary_stubbed(device):
    """tests/test_reloc_batch.py:91 as written: a faked trained detector,
    two database keyframes and a stubbed verification that reports
    reloc_min_inliers - 1 and then reloc_min_inliers inliers. Returns
    (accepted below, accepted at, Tcw at, the expected Tcw)."""
    system = SlamSystem(CAM320, RELOC_CFG, seed=0, device=device)
    ld = system.loop_detector
    V = RELOC_CFG.loop.vocab_size
    ld.words = torch.zeros((V, 8), dtype=torch.int32, device=system.device)
    ld.idf = torch.ones((V,), dtype=torch.float32, device=system.device)
    ld.count = 2
    ld.bow_db[:2] = 1.0
    system.store.poses_cw[0] = np.eye(4, dtype=np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T1[0, 3] = 0.5
    system.store.poses_cw[1] = T1
    system.store.count = 2
    ds = SyntheticDataset(n_frames=2, cam=CAM320, trajectory="orbit", device=device)
    _, gray, depth = ds.grab(0)
    f = system.tracker._extractor(gray, depth)
    calls = {}

    def fake_verify(cands, _f, ninl):
        calls["cands"] = list(cands)
        C = len(cands)
        T = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        T[:, 1, 3] = 0.25
        return (T, np.full((C,), ninl, np.int32), np.ones((C,), bool),
                np.full((C,), ninl, np.int32))

    th = RELOC_CFG.reloc_min_inliers
    system._verify_candidates = lambda cands, ff: fake_verify(cands, ff, th - 1)
    ok_below, _ = system._relocalize(f)
    system._verify_candidates = lambda cands, ff: fake_verify(cands, ff, th)
    ok_at, Tcw = system._relocalize(f)
    j = calls["cands"][0]
    expect = fake_verify([j], f, th)[0][0] @ system.store.poses_cw[j]
    return ok_below, ok_at, Tcw, expect


def reloc_boundary_verified(device, n_frames: int = 16):
    """The same boundary through the real verification (batched match and
    RANSAC of the bank keyframes, on the card the fused RANSAC): SlamSystem
    over orbit frames builds a keyframe database with the shipped
    vocabulary; a later frame is verified against its candidates with the
    generator's state saved, and _relocalize runs again from that state
    with reloc_min_inliers at the best candidate's inlier count n (accept)
    and at n + 1 (reject). Returns (n, accepted at n, accepted at n + 1,
    Tcw at n, the verified Tcw)."""
    from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary

    ds = SyntheticDataset(n_frames=48, cam=CAM320, trajectory="orbit", device=device)
    system = SlamSystem(CAM320, RELOC_CFG, seed=0, device=device)
    system.load_vocabulary(shipped_vocabulary("svo_fast"))
    for i in range(n_frames):
        system.track(*ds.grab(i))
    assert system.store.count >= 3
    _, gray, depth = ds.grab(n_frames + 2)
    f = system.tracker._extractor(gray, depth)
    state = system.generator.get_state()
    real_verify = system._verify_candidates
    seen = {}

    def verify(cands, ff):
        out = real_verify(cands, ff)
        seen["out"], seen["cands"] = out, list(cands)
        return out

    system._verify_candidates = verify
    ok0, _ = system._relocalize(f)
    T_b, ninl, ok_b, _ = seen["out"]
    live = [c for c in range(len(seen["cands"])) if ok_b[c]]
    best = max(live, key=lambda c: (int(ninl[c]), -c))
    n = int(ninl[best])
    expect = T_b[best] @ system.store.poses_cw[seen["cands"][best]]
    results = []
    for th in (n, n + 1):
        system.cfg = dataclasses.replace(system.cfg, reloc_min_inliers=th)
        system.generator.set_state(state)
        results.append(system._relocalize(f))
        assert seen["cands"] and int(seen["out"][1][best]) == n      # the same draws
    return n, results[0][0], results[1][0], results[0][1], expect


# ---------------------------------------------------------------------------
# tests/test_robustness.py:54
# ---------------------------------------------------------------------------


def second_reference_retry(device):
    """tests/test_robustness.py:54: the 20-frame sweep at 320x240 through
    the bare Tracker with frame 8 blank. Returns (failures, ATE)."""
    cfg = SlamConfig(extractor=ExtractorConfig(num_features=1024, num_levels=3, cell_size=8,
                                               fast_threshold=15.0))
    ds = SyntheticDataset(n_frames=20, cam=CAM320, trajectory="sweep", device=device)
    tracker = Tracker(CAM320, cfg, seed=0, device=device)
    blank = torch.zeros((240, 320), dtype=torch.float32, device=tracker.device)
    for i in range(len(ds)):
        ts, g, d = ds.grab(i)
        if i == 8:
            tracker.track(ts, blank, blank)
        else:
            tracker.track(ts, g, d)
    ts_e, poses = tracker.camera_trajectory()
    return tracker.stats.failures, ate_rmse(ts_e, poses, ds.timestamps, ds.poses_twc)[0]


# ---------------------------------------------------------------------------
# tests/test_orb_scale.py:80-110
# ---------------------------------------------------------------------------


def _roll(T: np.ndarray, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    out = T.copy()
    out[:3, :3] = T[:3, :3] @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return out


def dolly_roll(advance: float, roll: float, device):
    """tests/test_orb_scale.py:80-110: frame B advanced `advance` m towards
    the front wall and rolled by `roll` rad; both extracted by orb (x1.2, 8
    levels) and svo_fast, matched, RANSAC (generator seed 3). Returns
    (orb result, orb matches, svo result, the true T21)."""
    wall, eye_a = np.array([0.0, 0.0, 2.5]), np.array([0.0, 0.0, 0.3])
    Ta = look_at_pose(eye_a, wall)
    Tb = _roll(look_at_pose(eye_a + np.array([0.0, 0.0, advance]), wall), roll)
    ga, da = render_frame(CAM320, Ta, device=device)
    gb, db = render_frame(CAM320, Tb, device=device)
    T21_gt = np.linalg.inv(Tb) @ Ta
    cfg = ExtractorConfig(num_features=512, cell_size=8, fast_threshold=15.0, min_border=16)
    out = []
    for detector in ("orb", "svo_fast"):
        ex = Extractor(CAM320, cfg, detector=detector)
        fa, fb = ex(ga, da), ex(gb, db)
        m = match_descriptors(fa.desc, fa.obs_valid, fb.desc, fb.obs_valid, 0.9)
        mvalid = m.valid & fb.obs_valid[m.idx2.long()]
        p1, p2 = fa.xyz, fb.xyz[m.idx2.long()]
        w = correspondence_weights(p1, p2, mvalid)
        gen = torch.Generator(device=p1.device).manual_seed(3)
        out.append((ransac_se3(p1, p2, w, mvalid, gen, RansacConfig()), int(mvalid.sum())))
    return out[0][0], out[0][1], out[1][0], T21_gt


# ---------------------------------------------------------------------------
# tests/test_extractor_cli.py:56
# ---------------------------------------------------------------------------


def adaptive_scene_change(device):
    """tests/test_extractor_cli.py:56: a contrast-crushed frame (x0.25) at
    128x96; the ADAPTIVE extractor's one-shot build at its threshold and its
    within-frame retry. Returns (one-shot keypoints, after the retry)."""
    cam = Camera(80.0, 80.0, 63.5, 47.5, width=128, height=96)
    cfg = ExtractorConfig(num_features=128, num_levels=2, cell_size=8, fast_threshold=15.0)
    _, gray, depth = SyntheticDataset(n_frames=1, cam=cam, device=device).grab(0)
    dim = gray * 0.25
    ex = Extractor(cam, cfg, adaptive=True, target_min=60, target_max=120)
    n_oneshot = int(ex.build(dim, depth, ex.threshold).valid.sum())
    return n_oneshot, int(ex(dim, depth).valid.sum())


# ---------------------------------------------------------------------------
# tests/test_multiroom.py:50
# ---------------------------------------------------------------------------


def multiroom_run(device):
    """tests/test_multiroom.py:50: the 96-frame two-room tour at 160x120
    (cells of 6) through SlamSystem. Returns (system, ATE)."""
    cfg = SlamConfig(
        extractor=ExtractorConfig(num_features=384, num_levels=3, cell_size=6,
                                  fast_threshold=12.0, min_response=8.0, min_border=16),
        loop=LoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=256),
    )
    n = 96
    ds = SyntheticDataset(n_frames=n, cam=CAM160, trajectory="tour", device=device)
    system = SlamSystem(CAM160, cfg, seed=0, device=device)
    for i in range(n):
        system.track(*ds.grab(i))
    system.finish()
    ts_c, poses_c = system.camera_trajectory()
    return system, ate_rmse(ts_c, poses_c, ds.timestamps, ds.poses_twc)[0]
