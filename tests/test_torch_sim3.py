"""Sim(3) maps, the scale-aware Umeyama fit and the Sim(3) pose graph,
rgbdslam_tpu_torch against rgbdslam_tpu on the same numpy inputs, and the
JAX suite's Sim(3) behaviour tests (tests/test_sim3.py) on the port alone.

Tolerances: exp, log, inverse and scale_of within 1e-5 (the same f32
series in the same term order; the port's 3x3 determinant and solve are
written out where JAX factors by LU); `weighted_similarity_transform`
within 1e-5; `optimize_sim3_graph` on the scale-drift graph within 1e-4
(the dense solves and scatter-adds sum in different orders). The behaviour
tests keep the JAX tests' own bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.geometry import sim3 as jsim3
from rgbdslam_tpu.solvers import kabsch as jkabsch
from rgbdslam_tpu.solvers import pose_graph as jpg
from rgbdslam_tpu_torch.geometry import se3 as tse3
from rgbdslam_tpu_torch.geometry import sim3 as tsim3
from rgbdslam_tpu_torch.solvers import kabsch as tkabsch
from rgbdslam_tpu_torch.solvers import pose_graph as tpg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy


def rand_xi7(rng, t=0.5, r=0.5, s=0.3):
    """tests/test_sim3.py's tangent draw."""
    return np.concatenate([
        rng.normal(scale=t, size=3),
        ScipyRot.random(random_state=int(rng.integers(1 << 30))).as_rotvec()
        * rng.uniform(0, r) / np.pi,
        [rng.normal(scale=s)],
    ]).astype(np.float32)


def _xi_batch(seed, n=32):
    rng = np.random.default_rng(seed)
    return np.stack([rand_xi7(rng) for _ in range(n)])


# ------------------------------------------------------------------ parity


def test_exp_log_inverse_scale_match_jax():
    xi = _xi_batch(10)
    S_j = np.asarray(jsim3.exp(jnp.asarray(xi)))
    S_t = tsim3.exp(T(xi))
    np.testing.assert_allclose(S_t.numpy(), S_j, atol=1e-5)
    np.testing.assert_allclose(tsim3.log(T(S_j)).numpy(),
                               np.asarray(jsim3.log(jnp.asarray(S_j))), atol=1e-5)
    np.testing.assert_allclose(tsim3.inverse(T(S_j)).numpy(),
                               np.asarray(jsim3.inverse(jnp.asarray(S_j))), atol=1e-5)
    np.testing.assert_allclose(tsim3.scale_of(T(S_j)).numpy(),
                               np.asarray(jsim3.scale_of(jnp.asarray(S_j))), atol=1e-5)
    pts = np.random.default_rng(11).normal(size=(32, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tsim3.transform_points(T(S_j), T(pts)).numpy(),
        np.asarray(jsim3.transform_points(jnp.asarray(S_j), jnp.asarray(pts))), atol=1e-5)
    Tr = np.asarray(tse3.exp(T(xi[:, :6])))
    np.testing.assert_allclose(tsim3.from_se3(T(Tr), 1.3).numpy(),
                               np.asarray(jsim3.from_se3(jnp.asarray(Tr), 1.3)), atol=1e-6)


def _similarity_problem(seed, n=64, outliers=0):
    rng = np.random.default_rng(seed)
    S = np.asarray(jsim3.exp(jnp.asarray(rand_xi7(rng))))
    p1 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    p2 = (p1 @ S[:3, :3].T + S[:3, 3] + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    p2[:outliers] += rng.normal(0, 1.0, (outliers, 3)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return S, p1, p2, w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_similarity_transform_matches_jax(seed):
    S, p1, p2, w = _similarity_problem(seed, outliers=5)
    w[-3:] = 0.0
    S_j = np.asarray(jkabsch.weighted_similarity_transform(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w)))
    S_t = tkabsch.weighted_similarity_transform(T(p1), T(p2), T(w)).numpy()
    np.testing.assert_allclose(S_t, S_j, atol=1e-5)
    # batched, with a degenerate (all-zero weights) row: the identity
    wb = np.stack([w, np.zeros_like(w)])
    S_b = tkabsch.weighted_similarity_transform(
        T(np.stack([p1, p1])), T(np.stack([p2, p2])), T(wb)).numpy()
    np.testing.assert_allclose(S_b[0], S_j, atol=1e-5)
    np.testing.assert_array_equal(S_b[1], np.eye(4, dtype=np.float32))


def test_weighted_similarity_transform_scale_floor():
    """A reflected point set (s would come out negative) keeps s >= 1e-6, as
    the JAX fit clamps it."""
    p1 = np.random.default_rng(3).normal(size=(16, 3)).astype(np.float32)
    p2 = -p1
    w = np.ones(16, np.float32)
    S_t = tkabsch.weighted_similarity_transform(T(p1), T(p2), T(w))
    S_j = np.asarray(jkabsch.weighted_similarity_transform(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w)))
    np.testing.assert_allclose(S_t.numpy(), S_j, atol=1e-5)
    assert float(tsim3.scale_of(S_t)) > 0.0 or np.isfinite(S_t.numpy()).all()


def _drift_graph(n=10):
    """tests/test_sim3.py's chain whose odometry carries a x1.05 scale bias
    per step, closed by a scale-true loop edge."""
    gt = []
    for i in range(n):
        Tg = np.eye(4, dtype=np.float32)
        Tg[:3, 3] = [i * 0.5, 0, 0]
        gt.append(Tg)
    est = [gt[0].copy()]
    for _ in range(1, n):
        xi = np.zeros(7, np.float32)
        xi[0] = 0.5
        xi[6] = np.log(1.05)
        step = np.asarray(jsim3.exp(jnp.asarray(xi)))
        est.append((est[-1] @ step).astype(np.float32))
    a, b, Z, w = [], [], [], []
    for i in range(1, n):
        a.append(i), b.append(i - 1)
        Z.append(np.asarray(jsim3.inverse(jnp.asarray(est[i])) @ jnp.asarray(est[i - 1])))
        w.append(100.0)
    a.append(n - 1), b.append(0)
    Z.append(np.asarray(jsim3.inverse(jnp.asarray(gt[-1])) @ jnp.asarray(gt[0])))
    w.append(100.0)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return (np.stack(est).astype(np.float32), np.asarray(a, np.int32), np.asarray(b, np.int32),
            np.stack(Z).astype(np.float32), np.asarray(w, np.float32), fixed)


def _edges_t(a, b, Z, w):
    return tpg.PoseGraphEdges(a=T(a.astype(np.int64)), b=T(b.astype(np.int64)), Z=T(Z),
                              weight=T(w))


def _edges_j(a, b, Z, w):
    return jpg.PoseGraphEdges(a=jnp.asarray(a), b=jnp.asarray(b), Z=jnp.asarray(Z),
                              weight=jnp.asarray(w))


@pytest.mark.parametrize("adaptive", [True, False])
def test_optimize_sim3_graph_matches_jax(adaptive):
    est, a, b, Z, w, fixed = _drift_graph()
    S_j, c_j = jpg.optimize_sim3_graph(jnp.asarray(est), _edges_j(a, b, Z, w),
                                       jnp.asarray(fixed), 20, 1.0, 1e-4, adaptive)
    S_t, c_t = tpg.optimize_sim3_graph(T(est), _edges_t(a, b, Z, w), T(fixed), 20, 1.0,
                                       1e-4, adaptive)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), atol=1e-4)
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-3, atol=1e-4)


def test_sim3_residual_and_jacobians_match_jax():
    xi = _xi_batch(12, 6)
    Sa = np.asarray(jsim3.exp(jnp.asarray(xi[:3])))
    Sb = np.asarray(jsim3.exp(jnp.asarray(xi[3:])))
    Z = np.asarray(jsim3.inverse(jnp.asarray(Sa)) @ jnp.asarray(Sb))
    Z = Z @ np.asarray(jsim3.exp(jnp.asarray(0.05 * xi[:3])))
    for k in range(3):
        rj, Jaj, Jbj = jpg._sim3_residual_and_jacobians(
            jnp.asarray(Sa[k]), jnp.asarray(Sb[k]), jnp.asarray(Z[k]))
        rt, Jat, Jbt = tpg._sim3_residual_and_jacobians(T(Sa[k]), T(Sb[k]), T(Z[k]))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
        np.testing.assert_allclose(Jat.numpy(), np.asarray(Jaj), atol=1e-4)
        np.testing.assert_allclose(Jbt.numpy(), np.asarray(Jbj), atol=1e-4)


# ------------------------------------------------- behaviour (port alone)


def test_sim3_exp_log_roundtrip():
    xi = _xi_batch(0)
    xi_rt = tsim3.log(tsim3.exp(T(xi))).numpy()
    np.testing.assert_allclose(xi_rt, xi, atol=2e-3)


def test_sim3_reduces_to_se3_at_zero_scale():
    rng = np.random.default_rng(1)
    xi7 = rand_xi7(rng, s=0.0)
    xi7[6] = 0.0
    np.testing.assert_allclose(tsim3.exp(T(xi7)).numpy(), tse3.exp(T(xi7[:6])).numpy(),
                               atol=1e-5)


def test_sim3_scale_action():
    S = tsim3.exp(T(np.r_[0, 0, 0, 0, 0, 0, np.log(2.0)].astype(np.float32)))
    assert abs(float(tsim3.scale_of(S)) - 2.0) < 1e-5
    out = tsim3.transform_points(S, T(np.array([[1.0, 2.0, 3.0]], np.float32))).numpy()
    np.testing.assert_allclose(out, [[2.0, 4.0, 6.0]], atol=1e-5)


def test_sim3_inverse():
    S = tsim3.exp(T(rand_xi7(np.random.default_rng(2))))
    np.testing.assert_allclose((S @ tsim3.inverse(S)).numpy(), np.eye(4), atol=1e-5)


def test_sim3_edge_residual_zero_when_consistent():
    rng = np.random.default_rng(3)
    Sa = tsim3.exp(T(rand_xi7(rng)))
    Sb = tsim3.exp(T(rand_xi7(rng)))
    r = tpg.sim3_edge_residual(Sa, Sb, tsim3.inverse(Sa) @ Sb).numpy()
    np.testing.assert_allclose(r, 0.0, atol=1e-5)


def test_sim3_graph_corrects_scale_drift():
    est, a, b, Z, w, fixed = _drift_graph()
    scale_end_before = float(tsim3.scale_of(T(est[-1])))
    assert scale_end_before > 1.4
    S_opt, cost = tpg.optimize_sim3_graph(T(est), _edges_t(a, b, Z, w), T(fixed),
                                          iterations=20)
    scale_end_after = float(tsim3.scale_of(S_opt[-1]))
    assert abs(np.log(scale_end_after)) < 0.6 * abs(np.log(scale_end_before))
    assert np.isfinite(float(cost))


# --------------------- LM behaviours (tests/test_lm.py) on the Sim(3) graph


def _noisy_drift_graph(scale=0.3, seed=4):
    est, a, b, Z, w, fixed = _drift_graph()
    rng = np.random.default_rng(seed)
    xi = (scale * rng.normal(size=(len(est), 7))).astype(np.float32)
    xi[0] = 0.0
    est = (tsim3.exp(T(xi)) @ T(est)).numpy()
    return est, _edges_t(a, b, Z, w), T(fixed)


def test_sim3_lm_cost_monotone():
    """Accepted-step costs never rise (LM keeps no step that raises the
    robust objective), and the corrupted chain converges."""
    est, edges, fixed = _noisy_drift_graph()
    costs = [float(tpg.sim3_graph_cost(T(est), edges, 1.0))]
    for it in (1, 2, 4, 8, 16):
        S_opt, _ = tpg.optimize_sim3_graph(T(est), edges, fixed, it, 1.0, 1e-4)
        costs.append(float(tpg.sim3_graph_cost(S_opt, edges, 1.0)))
    for c_prev, c_next in zip(costs, costs[1:]):
        assert c_next <= c_prev * (1 + 1e-4)
    assert costs[-1] < 1e-2 * costs[0]


def test_sim3_lm_rejected_step_holds_pose():
    """From any lambda the solve never raises the cost; a step that would
    raise it is rejected and the vertices stay where they were."""
    est, edges, fixed = _noisy_drift_graph(scale=1.0, seed=5)
    c0 = float(tpg.sim3_graph_cost(T(est), edges, 1.0))
    for lam0 in (1e-8, 1e-4, 1e2):
        S_opt, _ = tpg.optimize_sim3_graph(T(est), edges, fixed, 6, 1.0, lam0)
        c = float(tpg.sim3_graph_cost(S_opt, edges, 1.0))
        assert np.isfinite(c)
        assert c <= c0 * (1 + 1e-4)
    # a huge damping floor: every step is tiny or rejected; a rejected step
    # leaves the estimate bit-equal
    S_one, _ = tpg.optimize_sim3_graph(T(est), edges, fixed, 1, 1.0, 1e8)
    c1 = float(tpg.sim3_graph_cost(S_one, edges, 1.0))
    assert c1 <= c0 * (1 + 1e-4)
    if c1 == c0:
        assert torch.equal(S_one, T(est))
