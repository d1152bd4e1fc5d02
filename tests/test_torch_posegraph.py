"""Pose-graph solvers and the SE(3) maps they use, rgbdslam_tpu_torch against
rgbdslam_tpu on the same numpy inputs (a seeded noisy ring graph).

Tolerances: residuals and Jacobians 1e-5 (the same f32 chain through
forward-mode autodiff in both); optimized poses rtol 1e-4 / atol 1e-4 and
the final cost rtol 1e-3 (the dense solves and the scatter-adds sum in
different orders; LM's accept/reject is the same on these graphs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.geometry import se3 as jse3
from rgbdslam_tpu.solvers import cg as jcg
from rgbdslam_tpu.solvers import pose_graph as jpg
from rgbdslam_tpu_torch import convert
from rgbdslam_tpu_torch.geometry import se3 as tse3
from rgbdslam_tpu_torch.solvers import cg as tcg
from rgbdslam_tpu_torch.solvers import pose_graph as tpg


def _exp(xi):
    return np.asarray(jse3.exp(jnp.asarray(np.asarray(xi, dtype=np.float32))))


def _ring(seed, K=24, noise=0.04, extra=3):
    """Ground-truth ring of K poses, noisy initial estimates, odometry
    edges around the ring plus `extra` chords and one zero-weight slot."""
    rng = np.random.default_rng(seed)
    T = np.stack([_exp([np.cos(2 * np.pi * i / K), 0.1 * rng.normal(),
                        np.sin(2 * np.pi * i / K), 0.0, 2 * np.pi * i / K * 0.9, 0.0])
                  for i in range(K)])
    a = np.r_[np.arange(1, K + 1) % K, rng.integers(0, K, extra), 3]
    b = np.r_[np.arange(K), rng.integers(0, K, extra), 7]
    keep = a != b
    a, b = a[keep], b[keep]
    Z = np.stack([np.linalg.inv(T[i].astype(np.float64)) @ T[j] for i, j in zip(a, b)])
    Z = Z.astype(np.float32)
    Tn = np.stack([_exp(noise * rng.normal(size=6)) @ t for t in T]).astype(np.float32)
    Tn[0] = T[0]
    w = np.full(len(a), 100.0, np.float32)
    w[-1] = 0.0                                    # an invalid (padding) slot
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return T, Tn, a, b, Z, w, fixed


def _edges(a, b, Z, w):
    je = jpg.PoseGraphEdges(jnp.asarray(a.astype(np.int32)), jnp.asarray(b.astype(np.int32)),
                            jnp.asarray(Z), jnp.asarray(w))
    return je, convert.pose_graph_edges_from_numpy(a, b, Z, w, device="cpu")


@pytest.mark.parametrize("name", ["inverse", "log", "log_smooth", "so3_log",
                                  "so3_log_smooth", "transform_points"])
def test_se3_maps_match(name):
    rng = np.random.default_rng(1)
    xi = rng.normal(scale=0.6, size=(64, 6)).astype(np.float32)
    xi[0] = 0.0                                       # the identity
    xi[1, 3:] = [np.pi - 1e-4, 0.0, 0.0]              # near pi
    xi[2, 3:] *= 1e-5                                 # small angle
    T = np.asarray(jse3.exp(jnp.asarray(xi)))
    if name == "transform_points":
        pts = rng.normal(size=(64, 10, 3)).astype(np.float32)
        ref = np.asarray(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts)))
        out = tse3.transform_points(torch.from_numpy(T), torch.from_numpy(pts)).numpy()
    elif name.startswith("so3"):
        ref = np.asarray(getattr(jse3, name)(jnp.asarray(T[:, :3, :3])))
        out = getattr(tse3, name)(torch.from_numpy(T[:, :3, :3].copy())).numpy()
    else:
        ref = np.asarray(getattr(jse3, name)(jnp.asarray(T)))
        out = getattr(tse3, name)(torch.from_numpy(T)).numpy()
    # same f32 formulas; sin/cos/atan2 differ by an ulp between the libraries
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


def test_edge_residuals_and_jacobians_match():
    _, Tn, a, b, Z, w, _ = _ring(0)
    r, Ja, Jb = jax.vmap(jpg._residual_and_jacobians)(
        jnp.asarray(Tn[a]), jnp.asarray(Tn[b]), jnp.asarray(Z))
    rt, Jat, Jbt = tpg.residuals_and_jacobians(
        torch.from_numpy(Tn[a]), torch.from_numpy(Tn[b]), torch.from_numpy(Z))
    assert rt.dtype == torch.float32 and Jat.shape == (len(a), 6, 6)
    np.testing.assert_allclose(rt.numpy(), np.asarray(r), rtol=0, atol=1e-5)
    np.testing.assert_allclose(Jat.numpy(), np.asarray(Ja), rtol=0, atol=1e-5)
    np.testing.assert_allclose(Jbt.numpy(), np.asarray(Jb), rtol=0, atol=1e-5)
    # a residual at the identity has finite derivatives (the smooth log)
    r0, J0, _ = tpg.residuals_and_jacobians(
        torch.from_numpy(Tn[:2]), torch.from_numpy(Tn[:2]),
        torch.eye(4).expand(2, 4, 4).contiguous())
    assert torch.isfinite(J0).all() and float(r0.abs().max()) < 1e-6


def test_graph_cost_and_huber_match():
    _, Tn, a, b, Z, w, _ = _ring(1, noise=0.3)
    je, te = _edges(a, b, Z, w)
    for delta in (1.0, 0.05):
        cj = float(jpg.graph_cost(jnp.asarray(Tn), je, delta))
        ct = float(tpg.graph_cost(torch.from_numpy(Tn), te, delta))
        np.testing.assert_allclose(ct, cj, rtol=1e-5)


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("seed,adaptive", [(0, True), (1, True), (2, False)])
def test_optimize_pose_graph_matches(solver, seed, adaptive):
    T, Tn, a, b, Z, w, fixed = _ring(seed)
    je, te = _edges(a, b, Z, w)
    if solver == "dense":
        Tj, cj = jpg.optimize_pose_graph(jnp.asarray(Tn), je, jnp.asarray(fixed),
                                         10, 1.0, 1e-4, adaptive)
        Tt, ct = tpg.optimize_pose_graph(torch.from_numpy(Tn), te, torch.from_numpy(fixed),
                                         10, 1.0, 1e-4, adaptive)
    else:
        Tj, cj = jcg.optimize_pose_graph_cg(jnp.asarray(Tn), je, jnp.asarray(fixed),
                                            10, 64, 1.0, 1e-4, adaptive)
        Tt, ct = tcg.optimize_pose_graph_cg(torch.from_numpy(Tn), te,
                                            torch.from_numpy(fixed), 10, 64, 1.0, 1e-4,
                                            adaptive)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-4, atol=1e-4)
    # the final costs are ~1e-10 (a consistent ring): compare on the scale of
    # the initial cost
    c0 = float(jpg.graph_cost(jnp.asarray(Tn), je, 1.0))
    assert abs(float(ct) - float(cj)) <= 1e-3 * max(float(cj), 1e-6 * c0)
    # and the solve recovers the ring
    np.testing.assert_allclose(Tt.numpy(), T, atol=2e-3)
    np.testing.assert_array_equal(Tt.numpy()[0], Tn[0])          # gauge vertex


@pytest.mark.parametrize("cg_threshold", [256, 8])
def test_pose_graph_registry_matches(cg_threshold):
    """The host registry: the same vertices and edges through both
    packages' PoseGraph (dense below the CG threshold, CG at it)."""
    T, Tn, a, b, Z, w, _ = _ring(3, K=12)
    gj = jpg.PoseGraph(4, 4, cg_threshold=cg_threshold)          # both budgets grow
    gt = tpg.PoseGraph(4, 4, cg_threshold=cg_threshold, device="cpu")
    for g in (gj, gt):
        for k in range(12):
            assert g.add_vertex(Tn[k]) == k
            if k > 0:
                g.add_odometry_edge(k, k - 1)
        for i, j, z in zip(a[12:-1], b[12:-1], Z[12:-1]):
            if not g.has_edge(int(i), int(j)):
                g.add_edge(int(i), int(j), z)
        g.add_edge(0, 11, Z[11], kind=3)                         # closes the ring
    assert gt.n_edges == gj.n_edges and gt.n_vertices == 12
    assert gt.has_edge(11, 0) and gt.has_edge(3, 3) and not gt.has_edge(2, 9)
    np.testing.assert_array_equal(gt.e_a[: gt.n_edges], gj.e_a[: gj.n_edges])
    np.testing.assert_allclose(gt.e_Z[: gt.n_edges], gj.e_Z[: gj.n_edges], atol=1e-6)
    np.testing.assert_array_equal(gt.e_w[: gt.n_edges], gj.e_w[: gj.n_edges])
    oj, ot = gj.optimize(10), gt.optimize(10)
    np.testing.assert_allclose(ot, oj, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(gt.Twc[:12], ot)
    # with a mesh of two shards (the distributed backend, ported) the same
    # graph's next solve rides the edge-sharded CG LM, from the optimum
    from rgbdslam_tpu_torch.parallel import make_mesh

    gt.mesh = make_mesh(2, device="cpu")
    np.testing.assert_allclose(gt.optimize(10), ot, rtol=0, atol=2e-3)
    assert gt.dist_solves == 1


def test_pose_graph_needs_more_than_five_vertices():
    g = tpg.PoseGraph(8, 8, device="cpu")
    for k in range(5):
        g.add_vertex(np.eye(4, dtype=np.float32))
    assert g.optimize(5).shape == (5, 4, 4)


def test_pcg_solves_spd_system():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(24, 24)).astype(np.float32)
    A = A @ A.T + 24 * np.eye(24, dtype=np.float32)
    x_true = rng.normal(size=(4, 6)).astype(np.float32)
    bvec = (A @ x_true.reshape(-1)).reshape(4, 6)
    At = torch.from_numpy(A)
    x = tcg.pcg(lambda v: (At @ v.reshape(-1)).reshape(4, 6), lambda v: v / 24.0,
                torch.from_numpy(bvec), 40)
    xj = jcg.pcg(lambda v: (jnp.asarray(A) @ v.reshape(-1)).reshape(4, 6),
                 lambda v: v / 24.0, jnp.asarray(bvec), 40)
    np.testing.assert_allclose(x.numpy(), x_true, atol=1e-4)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-4)
