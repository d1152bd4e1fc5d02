"""The Levenberg-Marquardt behaviours of tests/test_lm.py (:100-138, :170)
on the port alone, held to that file's own bounds with no JAX re-run
(ROADMAP item 24's LM bullet; the Sim(3) graph's monotone cost and held
pose are in tests/test_torch_sim3.py):

- a near-degenerate BA (low-parallax, reprojection only) where
  fixed-damping Gauss-Newton diverges and LM converges;
- the pose-graph LM's accepted costs never rise, and a corrupted circle
  converges;
- from any lambda the solve never raises the cost (a rejected step holds
  the pose);
- `PoseGraphConfig.lm_lambda0` reaches the host PoseGraph.
The problems are tests/test_lm.py's, built with numpy.
"""

import numpy as np
import torch

from rgbdslam_tpu_torch.config import SlamConfig
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.solvers.ba import BAProblem, _ba_cost, local_ba
from rgbdslam_tpu_torch.solvers.pose_graph import (PoseGraph, PoseGraphEdges, graph_cost,
                                                   optimize_pose_graph)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM = Camera(fx=200.0, fy=200.0, cx=80.0, cy=60.0, width=160, height=120)
T = torch.from_numpy


def _circle_graph(K=16, seed=0, init_scale=1.0):
    """Ground-truth circle graph, chain and loop edges (padded to 32 slots
    with zero-weight edges) and a corrupted init."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, K, endpoint=False)
    T_gt = []
    for t in th:
        c, s = np.cos(t), np.sin(t)
        Tw = np.eye(4, dtype=np.float32)
        Tw[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        Tw[:3, 3] = [2 * np.cos(t), 0, 2 * np.sin(t)]
        T_gt.append(Tw)
    T_gt = np.stack(T_gt)
    ea = list(range(1, K)) + [K - 1]
    eb = list(range(0, K - 1)) + [0]
    eZ = [(np.linalg.inv(T_gt[a]) @ T_gt[b]).astype(np.float32) for a, b in zip(ea, eb)]
    E, Ep = len(ea), 32
    sel = np.arange(Ep) < E
    edges = PoseGraphEdges(
        a=T(np.resize(np.array(ea, np.int64), Ep) * sel),
        b=T(np.resize(np.array(eb, np.int64), Ep) * sel),
        Z=T(np.concatenate([np.stack(eZ), np.tile(np.eye(4, dtype=np.float32),
                                                  (Ep - E, 1, 1))])),
        weight=T(np.concatenate([np.full(E, 100.0, np.float32),
                                 np.zeros(Ep - E, np.float32)])))
    xi = rng.normal(0, init_scale, (K, 6)).astype(np.float32)
    xi[0] = 0
    est = se3.exp(T(xi)) @ T(T_gt)
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    return est, edges, fixed


def _low_parallax_ba(seed=0):
    """Reprojection-only BA with a ~1 mm camera baseline: landmark depth is
    unconstrained, where an (almost) undamped Gauss-Newton step explodes."""
    rng = np.random.default_rng(seed)
    K, L, M = 4, 32, 4
    Tcw = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k in range(K):
        Tcw[k, 0, 3] = 0.001 * k
    Xw = np.stack([rng.uniform(-0.5, 0.5, L), rng.uniform(-0.4, 0.4, L),
                   rng.uniform(1.5, 3.0, L)], 1).astype(np.float32)
    obs_kf = np.tile(np.arange(K, dtype=np.int64), (L, 1))
    obs_uv = np.zeros((L, M, 2), np.float32)
    for k in range(K):
        Xc = Xw @ Tcw[k, :3, :3].T + Tcw[k, :3, 3]
        obs_uv[:, k, 0] = CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx + rng.normal(0, 0.5, L)
        obs_uv[:, k, 1] = CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy + rng.normal(0, 0.5, L)
    X0 = Xw * rng.uniform(0.7, 1.4, (L, 1)).astype(np.float32)
    pb = BAProblem(Tcw=T(Tcw), Xw=T(X0), lm_valid=torch.ones(L, dtype=torch.bool),
                   obs_kf=T(obs_kf), obs_uv=T(obs_uv),
                   obs_valid=torch.ones((L, M), dtype=torch.bool),
                   obs_z=torch.zeros((L, M)))
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    return pb, fixed


def test_ba_gn_diverges_lm_converges():
    """Fixed-damping GN blows the objective up by more than 10x; LM's never
    rises and reduces it. The near-singular solve makes both paths depend
    on f32 rounding: from the same inputs JAX's first GN step gives 189 and
    the port's 4,484 (c0 = 66), JAX's GN ends at ~6e4 after 20 steps and
    the port's falls back to ~24, so the 10x bound is held on the largest
    cost of the GN path (1, 2, 5, 10 and 20 steps). JAX's f32 LM accepts
    its second step and ends at 11.5 (the JAX test's bound is < 0.5 c0);
    JAX's own float64 LM rejects that step and ends at 38.24 after 20, as
    the port's float64 LM does: the port's f32 LM is held within 1 % of
    its float64 run and below 0.6 c0."""
    pb, fixed = _low_parallax_ba()
    pb64 = pb._replace(Tcw=pb.Tcw.double(), Xw=pb.Xw.double(), obs_uv=pb.obs_uv.double(),
                       obs_z=pb.obs_z.double())
    c0 = float(_ba_cost(CAM, pb.Tcw, pb.Xw, pb, 2.45, None, 1.0))
    c_gn, c_lm = [], [c0]
    for it in (1, 2, 5, 10, 20):
        Tg, Xg, _ = local_ba(CAM, pb, fixed, it, 2.45, 1e-6, None, 1.0, False)
        c_gn.append(float(_ba_cost(CAM, Tg, Xg, pb, 2.45, None, 1.0)))
        Tl, Xl, _ = local_ba(CAM, pb, fixed, it, 2.45, 1e-4, None, 1.0, True)
        c_lm.append(float(_ba_cost(CAM, Tl, Xl, pb, 2.45, None, 1.0)))
    assert max(c_gn) > 10.0 * c0         # GN blew up
    for c_prev, c_next in zip(c_lm, c_lm[1:]):
        assert c_next <= c_prev * (1 + 1e-4)
    T6, X6, _ = local_ba(CAM, pb64, fixed, 20, 2.45, 1e-4, None, 1.0, True)
    c64 = float(_ba_cost(CAM, T6, X6, pb64, 2.45, None, 1.0))
    assert abs(c_lm[-1] - c64) < 0.01 * c64
    assert c_lm[-1] < 0.6 * c0           # LM reduced the objective
    assert np.isfinite(Xl.numpy()).all()


def test_pose_graph_lm_cost_monotone():
    est, edges, fixed = _circle_graph(init_scale=1.5, seed=0)
    costs = []
    for it in (1, 2, 4, 8, 16):
        T_opt, _ = optimize_pose_graph(est, edges, fixed, it, 1.0, 1e-4)
        costs.append(float(graph_cost(T_opt, edges, 1.0)))
    for c_prev, c_next in zip(costs, costs[1:]):
        assert c_next <= c_prev * (1 + 1e-4)
    assert costs[-1] < 1e-3 * costs[0]


def test_pose_graph_lm_rejected_step_holds_pose():
    est, edges, fixed = _circle_graph(init_scale=2.0, seed=5)
    c0 = float(graph_cost(est, edges, 1.0))
    for lam0 in (1e-8, 1e-4, 1e2):
        T_opt, _ = optimize_pose_graph(est, edges, fixed, 6, 1.0, lam0)
        c = float(graph_cost(T_opt, edges, 1.0))
        assert np.isfinite(c)
        assert c <= c0 * (1 + 1e-4)


def test_lm_lambda0_field_is_live():
    cfg = SlamConfig()
    pg = PoseGraph(8, 8, lm_lambda0=cfg.pose_graph.lm_lambda0, device="cpu")
    assert pg.lm_lambda0 == cfg.pose_graph.lm_lambda0
