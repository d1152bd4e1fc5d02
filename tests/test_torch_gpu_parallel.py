"""The distributed backend on the card: the edge-sharded LMs and the
landmark-sharded BA on a mesh of 4 shards of one card against the plain
solves on the card and the same calls on 4 CPU shards, dp_odometry over 4
shards of the card against the CPU, and a distributed SlamSystem (chip_smoke.py
phase 13's checks at test size). Every test here is marked `gpu` and skips
without a card:

  python -m pytest -q --noconftest -m gpu tests/test_torch_gpu_parallel.py

Tolerances: the dense LM within 1e-4 of the plain solve and of the CPU; the
CG LM within 2e-3 of the dense solve (as tests/test_parallel.py) and 1e-4
of the CPU; the BA within 1e-3 of local_ba and of the CPU (poses) and 1e-3
(landmarks); dp_odometry's inlier counts equal to the CPU's with the same
injected draws, T21 within 1e-4. No host synchronisation inside a solve.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, SlamConfig
from rgbdslam_tpu_torch.device import virtual_devices
from rgbdslam_tpu_torch.eval.ate import ate_rmse
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
from rgbdslam_tpu_torch.ops import kernels
from rgbdslam_tpu_torch.parallel import dist_ba, dp_odometry, make_mesh
from rgbdslam_tpu_torch.slam.system import SlamSystem
from rgbdslam_tpu_torch.solvers import ba
from rgbdslam_tpu_torch.solvers.cg import optimize_pose_graph_cg
from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraphEdges, optimize_pose_graph

pytestmark = pytest.mark.gpu

SHARDS = 4
CAM = Camera(100.0, 100.0, 79.5, 59.5, width=160, height=120)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def chain_problem(seed: int, n: int = 24):
    """A perturbed chain with skip edges (tests/test_parallel.py's
    _chain_problem, numpy only): (truth, estimate, edges on the CPU)."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(scale=0.2, size=(n, 6)).astype(np.float32)
    xi[0] = 0
    gt = se3.exp(torch.from_numpy(xi)).numpy()
    noise = rng.normal(scale=0.05, size=(n, 6)).astype(np.float32)
    noise[0] = 0
    est = (se3.exp(torch.from_numpy(noise)) @ torch.from_numpy(gt)).numpy()
    a, b = [], []
    for i in range(1, n):
        a.append(i), b.append(i - 1)
        if i >= 2:
            a.append(i), b.append(i - 2)
    Z = np.stack([np.linalg.inv(gt[i]) @ gt[j] for i, j in zip(a, b)]).astype(np.float32)
    edges = PoseGraphEdges(a=torch.tensor(a), b=torch.tensor(b), Z=torch.from_numpy(Z),
                           weight=torch.full((len(a),), 100.0))
    return gt, est, edges


def on(edges, d):
    return PoseGraphEdges(*(t.to(d) for t in edges))


def no_sync(fn):
    """fn() with every synchronising call an error (its inputs already on
    the card: a copy from pageable host memory counts as one)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_dense_lm_on_four_shards_of_the_card(dev):
    gt, est, edges = chain_problem(0)
    fixed = torch.arange(len(est)) == 0
    T0 = torch.from_numpy(est)
    mesh = make_mesh(SHARDS, device="cuda")
    assert mesh.devices == (torch.device("cuda", 0),) * SHARDS
    shards = dist_ba.shard_edges(on(edges, dev), mesh)
    T0d, fd = T0.to(dev), fixed.to(dev)
    T_d, cost = no_sync(lambda: dist_ba.distributed_pose_graph_optimize(
        T0d, shards, fd, mesh, 10))
    T_p, _ = optimize_pose_graph(T0.to(dev), on(edges, dev), fixed.to(dev), 10)
    T_c, _ = dist_ba.distributed_pose_graph_optimize(T0, edges, fixed,
                                                    make_mesh(SHARDS, device="cpu"), 10)
    assert T_d.device.type == "cuda" and torch.isfinite(cost)
    np.testing.assert_allclose(T_d.cpu().numpy(), T_p.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(T_d.cpu().numpy(), T_c.numpy(), atol=1e-4)
    np.testing.assert_allclose(T_d.cpu().numpy(), gt, atol=1e-3)


def test_cg_lm_on_four_shards_of_the_card(dev):
    gt, est, edges = chain_problem(1)
    fixed = torch.arange(len(est)) == 0
    T0 = torch.from_numpy(est)
    mesh = make_mesh(SHARDS, device="cuda")
    T0d, ed, fd = T0.to(dev), on(edges, dev), fixed.to(dev)
    T_d, _ = no_sync(lambda: dist_ba.distributed_pose_graph_optimize_cg(
        T0d, ed, fd, mesh, 8, 64))
    assert mesh.reductions == 8 * (3 + 64)
    T_dense, _ = optimize_pose_graph(T0.to(dev), on(edges, dev), fixed.to(dev), 8)
    T_cg, _ = optimize_pose_graph_cg(T0.to(dev), on(edges, dev), fixed.to(dev), 8, 64)
    T_c, _ = dist_ba.distributed_pose_graph_optimize_cg(T0, edges, fixed,
                                                       make_mesh(SHARDS, device="cpu"), 8, 64)
    np.testing.assert_allclose(T_d.cpu().numpy(), T_dense.cpu().numpy(), atol=2e-3)
    np.testing.assert_allclose(T_d.cpu().numpy(), T_cg.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(T_d.cpu().numpy(), T_c.numpy(), atol=1e-4)


def ba_problem(seed: int, K: int = 6, L: int = 64, M: int = 6):
    """A noisy multi-view problem (tests/test_ba.py's make_problem, numpy
    only): observations of L landmarks from M of K keyframes."""
    rng = np.random.default_rng(seed)
    cam = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
    Xw = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 5.0], size=(L, 3)).astype(np.float32)
    xi = np.zeros((K, 6), np.float32)
    xi[:, 3] = np.linspace(0, 0.4, K)
    xi[:, 1] = np.linspace(0, 0.05, K)
    Tcw_gt = se3.exp(torch.from_numpy(xi)).numpy()
    noise = rng.normal(scale=0.01, size=(K, 6)).astype(np.float32)
    noise[0] = 0
    Tcw0 = (se3.exp(torch.from_numpy(noise)) @ torch.from_numpy(Tcw_gt)).numpy()
    kf = np.stack([rng.permutation(K)[:M] for _ in range(L)]).astype(np.int64)
    Xc = np.einsum("lmij,lj->lmi", Tcw_gt[kf][..., :3, :3], Xw) + Tcw_gt[kf][..., :3, 3]
    uv = np.stack([cam.fx * Xc[..., 0] / Xc[..., 2] + cam.cx,
                   cam.fy * Xc[..., 1] / Xc[..., 2] + cam.cy], -1).astype(np.float32)
    uv += rng.normal(scale=0.5, size=uv.shape).astype(np.float32)
    problem = ba.BAProblem(
        Tcw=torch.from_numpy(Tcw0),
        Xw=torch.from_numpy(Xw + rng.normal(scale=0.02, size=Xw.shape).astype(np.float32)),
        lm_valid=torch.ones(L, dtype=torch.bool), obs_kf=torch.from_numpy(kf),
        obs_uv=torch.from_numpy(uv), obs_valid=torch.ones((L, M), dtype=torch.bool),
        obs_z=torch.from_numpy(Xc[..., 2].astype(np.float32)))
    return cam, problem, Tcw_gt


def test_landmark_sharded_ba_on_four_shards_of_the_card(dev):
    cam, problem, Tcw_gt = ba_problem(3)
    fixed = torch.arange(6) == 0
    a = torch.tensor([1, 2, 3, 4, 5, 3])
    b = torch.tensor([0, 1, 2, 3, 4, 0])
    Z = torch.from_numpy(np.stack([Tcw_gt[i] @ np.linalg.inv(Tcw_gt[j])
                                   for i, j in zip(a.tolist(), b.tolist())]))
    edges = ba.BAEdges(a=a, b=b, Z=Z.float(), w=torch.full((6,), 100.0))
    mesh = make_mesh(SHARDS, device="cuda")
    pb_dev = ba.BAProblem(*(t.to(dev) for t in problem))
    e_dev = ba.BAEdges(*(t.to(dev) for t in edges))
    fd = fixed.to(dev)
    T_d, X_d, _ = no_sync(lambda: dist_ba.distributed_local_ba(
        cam, dist_ba.shard_landmarks(pb_dev, mesh), fd, mesh, 5, edges=e_dev))
    T_p, X_p, _ = ba.local_ba(cam, pb_dev, fixed.to(dev), 5, edges=e_dev)
    T_c, X_c, _ = dist_ba.distributed_local_ba(cam, problem, fixed,
                                              make_mesh(SHARDS, device="cpu"), 5, edges=edges)
    np.testing.assert_allclose(T_d.cpu().numpy(), T_p.cpu().numpy(), atol=1e-3)
    np.testing.assert_allclose(X_d.cpu().numpy(), X_p.cpu().numpy(), atol=1e-3)
    np.testing.assert_allclose(T_d.cpu().numpy(), T_c.numpy(), atol=1e-3)
    np.testing.assert_allclose(X_d.cpu().numpy(), X_c.numpy(), atol=1e-3)


def pair_draws(cfg, grays, depths, seed: int = 0) -> torch.Tensor:
    """RANSAC draws (S, T-1, H, sample) for every frame pair of the
    sequences, uniform over the pair's valid matches (counted by the plain
    build and matcher on the CPU, which the card's kernels equal)."""
    from rgbdslam_tpu_torch.frontend.frame import build_frame_features
    from rgbdslam_tpu_torch.frontend.matcher import gather_matched_points, match_frames

    S, T = grays.shape[:2]
    H, smp = cfg.ransac.num_hypotheses, cfg.ransac.sample_size
    g = torch.Generator().manual_seed(seed)
    draws = torch.zeros((S, T - 1, H, smp), dtype=torch.int64)
    for s in range(S):
        f = [build_frame_features(CAM, grays[s, t], depths[s, t], cfg.extractor)
             for t in range(T)]
        for t in range(T - 1):
            m = match_frames(f[t], f[t + 1], cfg.matcher.nn_ratio)
            n_valid = max(int(gather_matched_points(f[t], f[t + 1], m)[3].sum()), 1)
            draws[s, t] = torch.randint(0, n_valid, (H, smp), generator=g)
    return draws


def test_dp_odometry_on_four_shards_of_the_card(dev):
    """S = 4 sequences of T = 4 frames: the card's kernels on every frame
    pair (the detection per frame, K2 + gate, RANSAC and K4 per pair), equal
    to the CPU's plain run with the same draws."""
    cfg = SlamConfig(extractor=ExtractorConfig(num_features=256, num_levels=2, cell_size=8,
                                               fast_threshold=10.0, min_response=5.0,
                                               min_border=16))
    S, T = 4, 4
    grays, depths = [], []
    for s in range(S):
        ds = SyntheticDataset(n_frames=T, cam=CAM, trajectory="sweep", seed=s, device="cpu")
        fr = [ds.grab(i) for i in range(T)]
        grays.append(torch.stack([f[1] for f in fr]))
        depths.append(torch.stack([f[2] for f in fr]))
    grays, depths = torch.stack(grays), torch.stack(depths)
    draws = pair_draws(cfg, grays, depths)
    mesh = dp_odometry.make_seq_mesh(SHARDS, device="cuda")
    kernels.reset_launch_counts()
    T21_d, n_d = dp_odometry.dp_odometry(CAM, cfg, mesh)(grays, depths, None, draws)
    launches = dict(kernels.LAUNCHES)
    T21_c, n_c = dp_odometry.dp_odometry(CAM, cfg, make_mesh(SHARDS, "seq", "cpu"))(
        grays, depths, None, draws)
    assert torch.equal(n_d.cpu(), n_c)
    np.testing.assert_allclose(T21_d.cpu().numpy(), T21_c.numpy(), atol=1e-4)
    assert launches["detect_keypoints_fused"] == S * T
    for k in ("hamming_match_2nn", "match_gates", "ransac_se3_fused", "gicp_refine_fused"):
        assert launches[k] == S * (T - 1), (k, launches)


def test_distributed_slam_on_four_shards_of_the_card(dev):
    """tests/test_torch_distributed_system.py on the card: every solve on
    the 4-shard mesh, the loop closed, the trajectory within 0.05 m of the
    plain run."""
    cfg = SlamConfig(extractor=ExtractorConfig(num_features=512, num_levels=3, cell_size=8,
                                               fast_threshold=15.0),
                     loop=LoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=256))
    n = 80
    ds = SyntheticDataset(n_frames=n, cam=CAM, trajectory="orbit", loops=1.15, device=dev)
    frames = [ds.grab(i) for i in range(n)]
    poses = {}
    for distributed in (False, True):
        with virtual_devices(SHARDS):
            system = SlamSystem(CAM, dataclasses.replace(cfg, distributed=distributed),
                                seed=0, device=dev)
            for f in frames:
                system.track(*f)
            system.finish()
        ts, poses[distributed] = system.camera_trajectory()
        rmse, _ = ate_rmse(ts, poses[distributed], ds.timestamps[:n], ds.poses_twc[:n])
        assert rmse < 0.10, (distributed, rmse)
        assert system.loops_closed >= 1
        assert system.graph.dist_solves == (len(system.loop_solve_ms) + 1 if distributed else 0)
    diff = np.linalg.norm(poses[True][:, :3, 3] - poses[False][:, :3, 3], axis=-1)
    assert float(diff.max()) < 0.05
