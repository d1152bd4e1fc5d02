"""The SE(3) loop solve's two kernels (csrc/pose_graph.cu), held on the CPU
through a step-by-step PyTorch model of what the CUDA code does.

The model is written as the kernels are: the residual by se3.log_smooth's
formula; the closed-form Jacobian Jb = J_r^-1(r) Ad(Tb^-1) from its 3x3
blocks M = A Rb^T and N = B Rb^T - M hat(tb), with the coefficients c1, c2
by four terms of their series below theta^2 = 1; Ja = -Jb; the Huber IRLS
weight and cost term; one JtJ and Jt r an edge; the scatter as explicit
per-edge sums into the dense H and g; the damping of the diagonal; the
trial poses by se3.exp's formula, their cost and the masked accept. It is
held against the plain jacfwd path of solvers/pose_graph.py and against
the JAX package's pose_graph.

Tolerances, each with its reason:
- Ja = -Jb under jacfwd in float64 to 1e-12: the identity the kernel rests
  on (one 6x6 an edge);
- r exact (the same formula and ops); J rtol 1e-4 / atol 1e-5 against the
  f32 jacfwd where that holds 1e-5 of float64 (theta = 0, the small-angle
  branch, theta >= 0.05): the closed form and forward-mode autodiff round
  differently. Between theta ~ 1e-4 and 0.05 jacfwd's f32 derivatives of
  log_smooth cancel (up to 2e-4 off float64 at 1e-3): there the model is
  held to float64 jacfwd at atol 1e-5;
- H, g and the cost rtol 1e-4, atol 1e-5 of the largest |entry|: the same
  blocks summed in another order (f32), and the Jacobians' rounding above;
- poses of whole solves atol 1e-4 (tests/test_torch_posegraph.py's bound
  between the packages); costs rtol 1e-3 of the initial cost's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.solvers import pose_graph as jpg
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.mesh import Mesh
from rgbdslam_tpu_torch.ops import kernels
from rgbdslam_tpu_torch.solvers import pose_graph as tpg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F32 = torch.float32
#: the JAX package's residuals and Jacobians, batched over the edges
JAX_BLOCKS = jax.jit(jax.vmap(jpg._residual_and_jacobians))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def mm3(X, Y):
    """3x3 products over leading dimensions, each entry summed k = 0, 1, 2
    as the kernel's matmul3."""
    return torch.stack([torch.stack([X[..., i, 0] * Y[..., 0, j] + X[..., i, 1] * Y[..., 1, j]
                                     + X[..., i, 2] * Y[..., 2, j] for j in range(3)], -1)
                        for i in range(3)], -2)


def model_coefficients(th2):
    """c1 = (1 - G) / theta^2, c2 = (1 - G + theta G' / 2) / theta^4 with
    G = (theta / 2) cot(theta / 2); four terms of their series below 1."""
    series = th2 < 1.0
    c1_s = 1.0 / 12.0 + th2 / 720.0 + th2 * th2 / 30240.0 + th2 * th2 * th2 / 1209600.0
    c2_s = (-1.0 / 720.0 - th2 / 15120.0 - th2 * th2 / 403200.0
            - th2 * th2 * th2 / 11975040.0)
    half = 0.5 * torch.sqrt(torch.where(series, 1.0, th2))
    sh = torch.sin(half)
    G = half * torch.cos(half) / sh
    th2_d = torch.where(series, 1.0, th2)
    c1_d = (1.0 - G) / th2_d
    c2_d = (1.0 - G + 0.5 * (G - half * half / (sh * sh))) / (th2_d * th2_d)
    return torch.where(series, c1_s, c1_d), torch.where(series, c2_s, c2_d)


def model_jacobian_b(r, Tb):
    """(E, 6, 6) Jb = [[M, N], [0, M]]: J_r^-1(r) = [[A, B], [0, A]] times
    Ad(Tb^-1) = [[Rb^T, -Rb^T hat(tb)], [0, Rb^T]]."""
    rho, phi = r[..., :3], r[..., 3:]
    c1, c2 = model_coefficients(torch.sum(phi * phi, -1))
    c1, c2 = c1[..., None, None], c2[..., None, None]
    F, P = se3.hat(phi), se3.hat(rho)
    FF, FP, PF = mm3(F, F), mm3(F, P), mm3(P, F)
    eye = torch.eye(3, dtype=r.dtype)
    A = (eye + 0.5 * F) + c1 * FF
    B = (0.5 * P + c1 * (FP + PF)) + c2 * (mm3(FF, PF) + mm3(FP, FF))
    RbT = Tb[..., :3, :3].transpose(-1, -2)
    M = mm3(A, RbT)
    N = mm3(B, RbT) - mm3(M, se3.hat(Tb[..., :3, 3]))
    top = torch.cat([M, N], -1)
    bottom = torch.cat([torch.zeros_like(M), M], -1)
    return torch.cat([top, bottom], -2)


def model_edges(X, a, b, Z, weight, delta):
    """Per edge: r (E, 6), Jb (E, 6, 6), the IRLS weight w and cost term."""
    Ta, Tb = X[a], X[b]
    r = tpg.edge_residual(Ta, Tb, Z)
    rn = torch.sqrt(torch.sum(r * r, -1))
    term = weight * torch.where(rn <= delta, rn * rn, 2.0 * delta * rn - delta * delta)
    w = weight * torch.where(rn <= delta, 1.0, delta / torch.clamp_min(rn, 1e-12))
    return r, model_jacobian_b(r, Tb), w, term


def model_normal_equations(X, a, b, Z, weight, delta, lam=None, fixed=None):
    """pose_graph_ne_kernel: the blocks of each weighted edge added into the
    dense H (6K, 6K) and g (6K,) one edge at a time, the costs summed, and
    with lam the damping of the diagonal (the kernel always damps; without
    lam the model gives its sums before the damping)."""
    K = X.shape[0]
    r, J, w, term = model_edges(X, a, b, Z, weight, delta)
    H = torch.zeros((6 * K, 6 * K), dtype=X.dtype)
    g = torch.zeros((6 * K,), dtype=X.dtype)
    for e in range(a.shape[0]):
        if float(w[e]) == 0.0:
            continue                                       # adds nothing
        Hs = (J[e].T @ J[e]) * w[e]
        gs = (J[e].T @ r[e]) * w[e]
        ia, ib = slice(6 * int(a[e]), 6 * int(a[e]) + 6), slice(6 * int(b[e]), 6 * int(b[e]) + 6)
        H[ia, ia] += Hs
        H[ib, ib] += Hs
        H[ia, ib] -= Hs
        H[ib, ia] -= Hs
        g[ia] -= gs
        g[ib] += gs
    if lam is not None:
        d = torch.diagonal(H).clone()
        boost = torch.where(fixed[:, None].expand(K, 6).reshape(-1), 1e9, lam + 1e-8)
        H[range(6 * K), range(6 * K)] = (d + boost) + lam * d
    return H, g, torch.sum(term)


def model_trial(X, sol, fixed, a, b, Z, weight, delta, cost_it, lam, adaptive=True):
    """pose_graph_trial_kernel: X_cand = exp(xi) X, xi = -sol (0 on fixed
    vertices), its cost, and the accept. Returns (X_next, lam_next,
    cost_next)."""
    xi = torch.where(fixed[:, None], 0.0, -sol.reshape(-1, 6))
    Xc = se3.exp(xi) @ X
    if not adaptive:
        return Xc, lam, cost_it
    cost_new = torch.sum(model_edges(Xc, a, b, Z, weight, delta)[3])
    accept = cost_new < cost_it
    lam_next = torch.clamp(torch.where(accept, lam * (1.0 / 3.0), lam * 2.0), 1e-9, 1e8)
    return (torch.where(accept, Xc, X), lam_next, torch.where(accept, cost_new, cost_it))


def model_lm(X, edges, fixed, iterations, delta=1.0, lam0=1e-4, adaptive=True):
    """_lm_on_card's loop on the model's kernels."""
    lam = torch.tensor(lam0, dtype=F32)
    cost = torch.tensor(float("inf"), dtype=F32)
    for _ in range(iterations):
        H, g, cost_it = model_normal_equations(X, *edges, delta, lam, fixed)
        sol = torch.linalg.solve_ex(H, g[:, None])[0][:, 0]
        X, lam, cost = model_trial(X, sol, fixed, *edges, delta, cost_it, lam, adaptive)
    return X, cost


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------


def edges_at_angle(E, angle, seed, dtype=torch.float64):
    """Ta, Tb, Z of E edges whose residuals turn by `angle` (random axes and
    translations of ~1 m), made in float64 and rounded to `dtype`."""
    g = torch.Generator().manual_seed(seed)
    Ta = se3.exp(torch.randn(E, 6, generator=g, dtype=torch.float64))
    Tb = se3.exp(torch.randn(E, 6, generator=g, dtype=torch.float64))
    d = torch.randn(E, 6, generator=g, dtype=torch.float64)
    d[:, 3:] = d[:, 3:] / torch.linalg.norm(d[:, 3:], dim=-1, keepdim=True) * angle
    Z = se3.inverse(Ta) @ Tb @ se3.exp(-d)
    return Ta.to(dtype), Tb.to(dtype), Z.to(dtype)


def graph(case, seed=0, K=24):
    """(X (K, 4, 4), edges, fixed) of a perturbed chain with chords, by case:
    "ring" noise 0.05; "large" residuals up to ~2.8 rad; "zero_weight" a
    third of the slots weight 0; "repeated" each (a, b) pair twice and one
    (b, a) reversed; "fixed" vertices 0 and K // 2 fixed."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(scale=0.3, size=(K, 6))
    xi[:, :3] *= 3.0
    truth = se3.exp(torch.from_numpy(xi))
    a = np.r_[np.arange(1, K), rng.integers(0, K, K // 2)]
    b = np.r_[np.arange(K - 1), rng.integers(0, K, K // 2)]
    keep = a != b
    a, b = a[keep], b[keep]
    if case == "repeated":
        a, b = np.r_[a, a, b[:3]], np.r_[b, b, a[:3]]
    Z = se3.inverse(truth[a]) @ truth[b]
    noise = rng.normal(scale=0.05, size=(K, 6))
    if case == "large":
        axes = rng.normal(size=(K, 3))
        noise[:, 3:] = axes / np.linalg.norm(axes, axis=-1, keepdims=True) * rng.uniform(
            0.0, 1.4, size=(K, 1))
    X = (se3.exp(torch.from_numpy(noise)) @ truth).to(F32)
    X[0] = truth[0].to(F32)
    weight = torch.full((len(a),), 100.0, dtype=F32)
    if case == "zero_weight":
        weight[::3] = 0.0
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    if case == "fixed":
        fixed[K // 2] = True
    edges = tpg.PoseGraphEdges(torch.from_numpy(a).long(), torch.from_numpy(b).long(),
                               Z.to(F32).contiguous(), weight)
    return X.contiguous(), edges, fixed


def _close(x, ref, rtol=1e-4, atol_scale=1e-5):
    ref = torch.as_tensor(np.asarray(ref))
    np.testing.assert_allclose(x.numpy(), ref.numpy(), rtol=rtol,
                               atol=atol_scale * float(ref.abs().max()))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("angle", [0.0, 1e-5, 1e-3, 0.5, 2.8])
def test_jacfwd_gives_ja_minus_jb_in_float64(angle):
    """The identity the kernel rests on: one 6x6 an edge."""
    Ta, Tb, Z = edges_at_angle(16, angle, seed=1)
    r, Ja, Jb = tpg.residuals_and_jacobians(Ta, Tb, Z)
    assert float(torch.linalg.norm(r[:, 3:], dim=-1).max()) == pytest.approx(angle, abs=1e-9)
    assert float((Ja + Jb).abs().max()) < 1e-12


@pytest.mark.parametrize("angle", [0.0, 1e-5, 0.05, 0.3, 1.0, 2.0, 2.8])
def test_model_jacobian_against_jacfwd(angle):
    """r exact, Ja and Jb against the f32 jacfwd and against float64."""
    Ta, Tb, Z = edges_at_angle(64, angle, seed=2, dtype=F32)
    r, Ja, Jb = tpg.residuals_and_jacobians(Ta, Tb, Z)
    _, Ja64, Jb64 = tpg.residuals_and_jacobians(Ta.double(), Tb.double(), Z.double())
    rm = tpg.edge_residual(Ta, Tb, Z)
    Jm = model_jacobian_b(rm, Tb)
    assert torch.equal(rm, r)
    np.testing.assert_allclose(Jm.numpy(), Jb.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose((-Jm).numpy(), Ja.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(Jm.double().numpy(), Jb64.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("angle", [1e-4, 3e-4, 1e-3, 3e-3, 1e-2])
def test_model_jacobian_where_f32_jacfwd_cancels(angle):
    """Between theta ~ 1e-4 and 0.05 the model holds float64's Jacobian,
    and the f32 jacfwd is the farther of the two from it."""
    Ta, Tb, Z = edges_at_angle(64, angle, seed=3, dtype=F32)
    _, _, Jb = tpg.residuals_and_jacobians(Ta, Tb, Z)
    _, _, Jb64 = tpg.residuals_and_jacobians(Ta.double(), Tb.double(), Z.double())
    Jm = model_jacobian_b(tpg.edge_residual(Ta, Tb, Z), Tb).double()
    np.testing.assert_allclose(Jm.numpy(), Jb64.numpy(), rtol=0, atol=1e-5)
    assert float((Jm - Jb64).abs().max()) <= float((Jb.double() - Jb64).abs().max())


@pytest.mark.parametrize("case", ["ring", "large", "zero_weight", "repeated", "fixed"])
def test_model_normal_equations_against_plain(case):
    """H, g and the cost against the plain scatter of edge_blocks, the
    damped system against _damped_step's step, and the JAX package's
    blocks."""
    X, edges, fixed = graph(case, seed=4)
    H, g, cost = model_normal_equations(X, *edges, 1.0)
    Hp, gp, costp = tpg._normal_equations(X, edges, 1.0, X.shape[0], 6, tpg.edge_blocks)
    _close(H, Hp)
    _close(g, gp)
    _close(cost, costp)
    if case == "zero_weight":
        assert int((edges.weight == 0).sum()) > 0
    # the damped system: the model's step against the plain damped solve
    lam = torch.tensor(1e-3, dtype=F32)
    Hd, gd, _ = model_normal_equations(X, *edges, 1.0, lam, fixed)
    xi = torch.where(fixed[:, None], 0.0, -torch.linalg.solve(Hd, gd).reshape(-1, 6))
    xi_p = tpg._damped_step(Hp, gp, lam, fixed, 6)
    _close(xi, xi_p, rtol=1e-3, atol_scale=1e-4)
    assert float(xi[fixed].abs().max()) == 0.0
    # the JAX package's system: its residuals, Jacobians and Huber weights
    # (vmap of its jacfwd), scattered here in float64
    r, Ja, Jb = (np.asarray(t, np.float64) for t in JAX_BLOCKS(
        *(jnp.asarray(t.numpy()) for t in (X[edges.a], X[edges.b], edges.Z))))
    rn = jnp.linalg.norm(jnp.asarray(r, jnp.float32), axis=-1)
    w = np.asarray(jpg._huber_weight(rn, 1.0), np.float64) * edges.weight.double().numpy()
    jcost = jpg._huber_cost(rn, jnp.asarray(edges.weight.numpy()), 1.0)
    K = X.shape[0]
    Hj = np.zeros((K, K, 6, 6), np.float64)
    gj = np.zeros((K, 6), np.float64)
    for e, (i, j) in enumerate(zip(edges.a.tolist(), edges.b.tolist())):
        Hj[i, i] += w[e] * Ja[e].T @ Ja[e]
        Hj[j, j] += w[e] * Jb[e].T @ Jb[e]
        Hj[i, j] += w[e] * Ja[e].T @ Jb[e]
        Hj[j, i] += w[e] * Jb[e].T @ Ja[e]
        gj[i] += w[e] * Ja[e].T @ r[e]
        gj[j] += w[e] * Jb[e].T @ r[e]
    _close(H, Hj.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K))
    _close(g, gj.reshape(-1))
    _close(cost, float(jcost))


@pytest.mark.parametrize("step", ["accept", "reject", "gauss_newton"])
def test_model_trial_against_plain(step):
    """One trial: exp(xi) X, its cost and the accept against se3.exp,
    graph_cost and _lm_update."""
    X, edges, fixed = graph("ring", seed=5)
    H, g, cost_it = tpg._normal_equations(X, edges, 1.0, X.shape[0], 6, tpg.edge_blocks)
    lam = torch.tensor(1e-4, dtype=F32)
    xi = tpg._damped_step(H, g, lam, fixed, 6)
    sol = -xi.reshape(-1)
    if step == "reject":
        sol = sol * 40.0
    adaptive = step != "gauss_newton"
    Xn, lam_n, cost_n = model_trial(X, sol, fixed, *edges, 1.0, cost_it, lam, adaptive)
    X_cand = se3.exp(xi if step != "reject" else xi * 40.0) @ X
    if adaptive:
        cost_new = tpg.graph_cost(X_cand, edges, 1.0)
        Xp, lam_p, cost_p = tpg._lm_update(cost_new < cost_it, lam, cost_it, cost_new, X,
                                           X_cand)
        assert bool(cost_new < cost_it) == (step == "accept")
    else:
        Xp, lam_p, cost_p = X_cand, lam, cost_it
    np.testing.assert_allclose(Xn.numpy(), Xp.numpy(), rtol=0, atol=1e-6)
    assert float(lam_n) == float(lam_p)
    np.testing.assert_allclose(float(cost_n), float(cost_p), rtol=1e-5)


@pytest.mark.parametrize("seed,adaptive", [(0, True), (1, True), (2, False)])
def test_model_lm_against_plain_and_jax(seed, adaptive):
    """Whole 10-iteration solves: the model's kernels, the plain path and
    the JAX package from the same poses."""
    X, edges, fixed = graph("ring", seed=seed)
    T_m, c_m = model_lm(X, edges, fixed, 10, adaptive=adaptive)
    T_p, c_p = tpg.optimize_pose_graph(X, edges, fixed, 10, 1.0, 1e-4, adaptive)
    je = jpg.PoseGraphEdges(jnp.asarray(edges.a.numpy().astype(np.int32)),
                            jnp.asarray(edges.b.numpy().astype(np.int32)),
                            jnp.asarray(edges.Z.numpy()), jnp.asarray(edges.weight.numpy()))
    T_j, c_j = jpg.optimize_pose_graph(jnp.asarray(X.numpy()), je, jnp.asarray(fixed.numpy()),
                                       10, 1.0, 1e-4, adaptive)
    np.testing.assert_allclose(T_m.numpy(), T_p.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(T_m.numpy(), np.asarray(T_j), rtol=0, atol=1e-4)
    c0 = float(tpg.graph_cost(X, edges, 1.0))
    for c in (float(c_p), float(c_j)):
        assert abs(float(c_m) - c) <= 1e-3 * max(c, 1e-6 * c0)


def test_cpu_path_launches_no_kernel():
    """CPU tensors take the plain jacfwd path (the same bits as before the
    kernels), and the kernel wrappers refuse them."""
    X, edges, fixed = graph("ring", seed=6)
    kernels.reset_launch_counts()
    T, _ = tpg.optimize_pose_graph(X, edges, fixed, 3)
    T_ref, _ = tpg._dense_lm(X, (edges,), fixed, Mesh([X.device]), 3, 1.0, 1e-4, True, 6,
                             tpg.edge_blocks, se3.exp, tpg.graph_cost)
    assert torch.equal(T, T_ref)
    assert kernels.LAUNCHES["pose_graph_normal_equations"] == 0
    assert kernels.LAUNCHES["pose_graph_trial"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        kernels.pose_graph_normal_equations(X, *edges, 1.0, torch.tensor(1e-4), fixed)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.pose_graph_trial(X, torch.zeros(6 * X.shape[0]), fixed, *edges, 1.0,
                                 torch.tensor(1.0), torch.tensor(1e-4))


def test_dense_solve_fits_the_kernels():
    """PoseGraph's size rule: on the CPU cg_threshold alone picks the dense
    solve; on the card a map past kernels.POSE_GRAPH_MAX_VERTICES takes the
    CG solve whatever cg_threshold allows."""
    M = kernels.POSE_GRAPH_MAX_VERTICES
    graph = tpg.PoseGraph(8, 8, cg_threshold=4096, device="cpu")
    assert graph.dense_fits(M + 1) and graph.dense_fits(2048) and not graph.dense_fits(2049)
    graph.device = torch.device("cuda")          # the rule alone: no tensor is made
    assert graph.dense_fits(M) and not graph.dense_fits(M + 1)
    graph.cg_threshold = 256
    assert graph.dense_fits(128) and not graph.dense_fits(129)
