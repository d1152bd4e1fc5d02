"""Bundle adjustment: landmark-keyframe Levenberg-Marquardt with the Schur
complement over landmark blocks (port of rgbdslam_tpu/solvers/ba.py).

The reference has no BA (its backend is pose-graph-only; landmarks are only
re-anchored after optimization, Core/Frame.cpp:437-454); SURVEY.md section
7, layer 7 and BASELINE config 3 ask for it. Structure:

- observations live in a fixed-shape landmark-major table: each landmark has
  up to M observations (keyframe index, pixel, measured depth, validity);
- per iteration all residuals and Jacobians are one batched evaluation over
  (L, M);
- the landmark blocks H_ll are batched closed-form 3x3 inverses; the
  reduced camera system (K keyframes, 6K x 6K) S = H_cc - sum_l G_l H_ll^-1
  G_l^T is assembled by products with the one-hot matrix of the observing
  keyframes (where the JAX package scatter-adds (L, M, M) 6x6 blocks): per
  landmark its rows G H_ll^-1 and G land in their keyframes' rows, and one
  matrix product over landmarks sums them. No scatter, no float atomics,
  and no slow path where padding piles thousands of zero blocks onto one
  keyframe;
- the reduced system is solved densely (`torch.linalg.solve_ex`, no error
  check on the host), then the landmarks are back-substituted.

Every iteration, the accept/reject included, is enqueued on the device: a
solve reads nothing back until its caller reads the result.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.mesh import Mesh
from rgbdslam_tpu_torch.solvers.pose_graph import _huber_cost, _lm_update
from rgbdslam_tpu_torch.solvers.ransac_se3 import _inv3x3


class BAEdges(NamedTuple):
    """Relative-pose factors folded into the BA normal equations.

    Landmark tracks drift with viewpoint (the detected corner slides), so a
    landmark-only global BA is less accurate than the pose graph built from
    dense RANSAC registrations. Joint optimization keeps both: the edge
    factors carry the pairwise registration information (the reference's
    g2o edges, Solver/PoseGraph.cpp:199-217), the landmark terms add
    cross-view structure."""

    a: torch.Tensor   # (E,) int64 vertex a (the 'current' side of Z = T_{a<-b})
    b: torch.Tensor   # (E,) int64 vertex b
    Z: torch.Tensor   # (E, 4, 4) measured T_{a<-b} in the Twc convention
    w: torch.Tensor   # (E,) information weight; 0 disables (padding)


class BAProblem(NamedTuple):
    Tcw: torch.Tensor        # (K, 4, 4) keyframe poses (world -> camera)
    Xw: torch.Tensor         # (L, 3) landmark positions
    lm_valid: torch.Tensor   # (L,) bool
    obs_kf: torch.Tensor     # (L, M) int64 observing keyframe index
    obs_uv: torch.Tensor     # (L, M, 2) f32 observed (undistorted) pixels
    obs_valid: torch.Tensor  # (L, M) bool
    obs_z: torch.Tensor      # (L, M) f32 measured depth (0 = no depth term).
    # The depth residual makes this an RGB-D BA: with free landmarks,
    # reprojection alone leaves a scale gauge (only pixel rays are
    # constrained); the measured z pins metric scale, weighted by the
    # Khoshelham model sigma_z = c z^2 (Solver/SolverSE3.cpp:289-297).


def _reproj_jacobians(cam: Camera, Tcw_o: torch.Tensor, Xw: torch.Tensor,
                      depth_sigma_factor: float = 0.01):
    """Residual pieces of the observations (u, v, z).

    Tcw_o: (..., 4, 4) per-observation poses; Xw: (..., 3) landmarks
    (broadcast). Returns the predicted (u, v, z) (..., 3), Jc (..., 3, 6)
    with respect to a left increment of the pose, Jl (..., 3, 3) with
    respect to the landmark, and the z row's weight 1 / sigma_z (the depth
    residual in units comparable to pixels under unit pixel noise)."""
    R = Tcw_o[..., :3, :3]
    t = Tcw_o[..., :3, 3]
    Xc = (R @ Xw[..., None])[..., 0] + t
    x, y = Xc[..., 0], Xc[..., 1]
    z = torch.clamp_min(Xc[..., 2], 1e-6)
    inv_z = 1.0 / z
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    uvz = torch.stack([u, v, Xc[..., 2]], dim=-1)

    zero = torch.zeros_like(inv_z)
    one = torch.ones_like(inv_z)
    duvz_dXc = torch.stack([
        torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z * inv_z], dim=-1),
        torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z * inv_z], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    # d(Xc)/d(xi) for Tcw <- exp(xi) Tcw: [I | -hat(Xc)]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[:-1] + (3, 3))
    dXc_dxi = torch.cat([eye, -se3.hat(Xc)], dim=-1)         # (..., 3, 6)
    Jc = duvz_dXc @ dXc_dxi
    Jl = duvz_dXc @ R
    sigma_z = depth_sigma_factor * z * z
    return uvz, Jc, Jl, 1.0 / torch.clamp_min(sigma_z, 1e-4)


def _edge_residuals(Tcw_a, Tcw_b, Z):
    """r = log(Z^-1 Tcw_a Tcw_b^-1), batched: the pose graph's g2o EdgeSE3
    error with Twc = Tcw^-1."""
    return se3.log_smooth(se3.inverse(Z) @ Tcw_a @ se3.inverse(Tcw_b))


def _ba_cost(cam: Camera, Tcw, Xw, problem: BAProblem, huber_delta: float,
             edges: Optional[BAEdges], edge_huber: float):
    """The robust BA objective at (Tcw, Xw) that the LM accept/reject
    compares: the plain Huber cost over the un-pruned observations, plus the
    edge factors."""
    uvz_hat, _, _, inv_sigma_z = _reproj_jacobians(cam, Tcw[problem.obs_kf], Xw[:, None, :])
    z = uvz_hat[..., 2]
    meas = torch.cat([problem.obs_uv, problem.obs_z[..., None]], dim=-1)
    sz = torch.where(problem.obs_z > 0, inv_sigma_z, 0.0)
    r = (uvz_hat - meas) * torch.stack([torch.ones_like(sz), torch.ones_like(sz), sz], dim=-1)
    ok = problem.obs_valid & problem.lm_valid[:, None] & (z > 0.05)
    cost = _huber_cost(torch.linalg.norm(r, dim=-1), ok.to(Tcw.dtype), huber_delta)
    if edges is not None:
        cost = cost + _edge_cost(Tcw, edges, edge_huber)
    return cost


def _edge_cost(Tcw, edges: BAEdges, edge_huber: float):
    """The edge factors' robust cost at Tcw."""
    r_e = _edge_residuals(Tcw[edges.a], Tcw[edges.b], edges.Z)
    return _huber_cost(torch.linalg.norm(r_e, dim=-1), edges.w, edge_huber)


def _edge_residual_jacobians(Tcw_a, Tcw_b, Z):
    """One edge's residual (6,) and its Jacobians (6, 6) x 2 with respect to
    left increments of Tcw_a and Tcw_b (the BA pose update
    Tcw <- exp(xi) Tcw), by forward-mode autodiff."""

    def f(x):
        # a leading dimension of one keeps the scalars of exp and log
        # one-dimensional: under vmap a zero-dimensional tensor promotes
        # with Python floats to float64
        E = se3.exp(x.reshape(2, 6))
        return _edge_residuals((E[0] @ Tcw_a)[None], (E[1] @ Tcw_b)[None], Z[None])[0]

    zero = torch.zeros((12,), dtype=Tcw_a.dtype, device=Tcw_a.device)
    J, r = torch.func.jacfwd(lambda x: (f(x),) * 2, has_aux=True)(zero)   # (6, 12)
    return r, J[:, :6], J[:, 6:]


class _Observations(NamedTuple):
    """The fixed parts of a problem's (or a landmark shard's) observation
    table: observing keyframes, their one-hot rows (L, M, K), (u, v, z)
    measurements and which carry a depth."""
    kf: torch.Tensor
    onehot: torch.Tensor
    meas: torch.Tensor
    has_z: torch.Tensor


def _observations(problem: BAProblem, K: int) -> _Observations:
    kf = problem.obs_kf.long()
    # the observing keyframes as one-hot rows: each scatter of the normal
    # equations becomes a product with these
    return _Observations(
        kf=kf, onehot=torch.nn.functional.one_hot(kf, K).to(problem.Tcw.dtype),
        meas=torch.cat([problem.obs_uv, problem.obs_z[..., None]], dim=-1),
        has_z=problem.obs_z > 0)


def _landmark_system(cam: Camera, problem: BAProblem, ob: _Observations, Tcw, Xw, lam,
                     huber_delta: float):
    """The landmarks' reduced camera system: H (K, 6, K, 6) and g (K, 6)
    with the landmark blocks eliminated, the un-pruned robust cost that the
    accept/reject compares, and what the landmark back-substitution needs
    (G, H_ll^-1, b_l, w). Over a shard of the landmarks it is that shard's
    share of the sums."""
    K = Tcw.shape[0]
    dtype, dev = Tcw.dtype, Tcw.device
    uvz_hat, Jc, Jl, inv_sigma_z = _reproj_jacobians(cam, Tcw[ob.kf], Xw[:, None, :])
    z = uvz_hat[..., 2]
    # the depth row in pixel-comparable units; no depth -> row off
    sz = torch.where(ob.has_z, inv_sigma_z, 0.0)
    scale = torch.stack([torch.ones_like(sz), torch.ones_like(sz), sz], dim=-1)
    r = (uvz_hat - ob.meas) * scale
    Jc = Jc * scale[..., None]
    Jl = Jl * scale[..., None]

    ok0 = problem.obs_valid & problem.lm_valid[:, None] & (z > 0.05)
    r_norm = torch.linalg.norm(r, dim=-1)
    # gross-outlier pruning (wrong data associations): beyond 10x the
    # Huber width an observation contributes nothing
    # (Solver/PnPSolver.cpp:117-124's chi^2 demotion idea)
    ok = ok0 & (r_norm < 10.0 * huber_delta)
    w_h = torch.where(r_norm > huber_delta,
                      huber_delta / torch.clamp_min(r_norm, 1e-9), 1.0)
    w = w_h * ok.to(dtype)                                 # (L, M)
    # accept/reject compares the un-pruned cost, as _ba_cost evaluates
    # the candidate (the prune shapes the quadratic model only)
    cost = _huber_cost(r_norm, ok0.to(dtype), huber_delta)

    # landmark blocks
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hll = torch.einsum("lmri,lmrj,lm->lij", Jl, Jl, w) + (lam + 1e-6) * eye3
    bl = torch.einsum("lmri,lmr,lm->li", Jl, r, w)
    Hll_inv = _inv3x3(Hll)
    # camera blocks, rhs and the coupling G = Jc^T W Jl per observation
    Hcc_o = torch.einsum("lmri,lmrj,lm->lmij", Jc, Jc, w)   # (L, M, 6, 6)
    bc_o = torch.einsum("lmri,lmr,lm->lmi", Jc, r, w)       # (L, M, 6)
    G = torch.einsum("lmri,lmrj,lm->lmij", Jc, Jl, w)       # (L, M, 6, 3)

    # the camera blocks on the diagonal and the rhs, less the landmarks'
    # Schur terms: S = sum_l U_l V_l^T with U_l (6K, 3) holding G_l,m
    # H_ll^-1 at its keyframe's rows and V_l holding G_l,m
    eye_k = torch.eye(K, dtype=dtype, device=dev)
    GHinv = torch.einsum("lmij,ljk->lmik", G, Hll_inv)        # (L, M, 6, 3)
    U = torch.einsum("lma,lmik->laik", ob.onehot, GHinv)      # (L, K, 6, 3)
    V = torch.einsum("lma,lmik->laik", ob.onehot, G)
    H = (torch.einsum("ab,aij->aibj", eye_k, torch.einsum("lma,lmij->aij", ob.onehot, Hcc_o))
         - torch.einsum("laik,lbjk->aibj", U, V))              # (K, 6, K, 6)
    # rhs reduction: g_red = g - G Hll^-1 bl
    g = torch.einsum("lma,lmi->ai", ob.onehot,
                     bc_o - torch.einsum("lmik,lk->lmi", GHinv, bl))   # (K, 6)
    return H, g, cost, (G, Hll_inv, bl, w)


def _edge_ends(edges: BAEdges, K: int) -> torch.Tensor:
    """The edges' ends as one-hot rows (2, E, K)."""
    return torch.nn.functional.one_hot(
        torch.stack([edges.a.long(), edges.b.long()]), K).to(edges.Z.dtype)


def _edge_system(Tcw, edges: BAEdges, ends, edge_huber: float):
    """The relative-pose factors' share of the camera system: H_e (K, 6, K,
    6), g_e (K, 6) and their robust cost. They touch poses only, so they
    are independent of the landmark elimination."""
    r_e, Ja, Jb = torch.func.vmap(_edge_residual_jacobians)(
        Tcw[edges.a.long()], Tcw[edges.b.long()], edges.Z)
    rn_e = torch.linalg.norm(r_e, dim=-1)
    hub = torch.where(rn_e > edge_huber, edge_huber / torch.clamp_min(rn_e, 1e-9), 1.0)
    we = (edges.w * hub)[:, None, None]
    Jab = torch.stack([Ja, Jb])                                # (2, E, 6, 6)
    blocks = we * torch.einsum("seri,terj->steij", Jab, Jab)   # (2, 2, E, 6, 6)
    rows = torch.einsum("sea,steij->teaij", ends, blocks)      # (2, E, K, 6, 6)
    He = torch.einsum("teaij,teb->aibj", rows, ends)
    ge = torch.einsum("sea,sei->ai", ends,
                      we[:, :, 0] * torch.einsum("seri,er->sei", Jab, r_e))
    return He, ge, _huber_cost(rn_e, edges.w, edge_huber)


def _pose_step(H, g, lam, fixed_kf):
    """The gauge prior, Marquardt damping and the dense solve of the reduced
    camera system: the pose increment xi (K, 6), 0 on the fixed keyframes."""
    K = fixed_kf.shape[0]
    Hm = H.reshape(K * 6, K * 6)
    gv = g.reshape(K * 6)
    fixed6 = fixed_kf[:, None].expand(K, 6).reshape(K * 6)
    diag_boost = torch.where(fixed6, 1e9, lam + 1e-8)
    Hm = Hm + torch.diag(diag_boost) + lam * torch.diag(torch.diagonal(Hm))
    xi = -torch.linalg.solve_ex(Hm, gv[:, None], check_errors=False)[0][:, 0]
    return torch.where(fixed_kf[:, None], 0.0, xi.reshape(K, 6))


def _landmark_step(problem: BAProblem, ob: _Observations, back, xi):
    """The landmark back-substitution dX = -Hll^-1 (bl + sum_m G^T xi[kf])
    (L, 3), 0 on landmarks without a weighted observation."""
    G, Hll_inv, bl, w = back
    Gt_xi = torch.einsum("lmij,lmi->lj", G, xi[ob.kf])
    dX = -torch.einsum("lij,lj->li", Hll_inv, bl + Gt_xi)
    obs_cnt = torch.sum(w, dim=1)
    return torch.where((problem.lm_valid & (obs_cnt > 0))[:, None], dX, 0.0)


def _schur_lm(cam: Camera, shards, fixed_kf, mesh: Mesh, iterations: int, huber_delta: float,
              lm_lambda0: float, edges: Optional[BAEdges], edge_huber: float, adaptive: bool):
    """The Schur-complement LM over the landmark shards of `mesh` (one
    BAProblem a local shard, the poses replicated; the plain solve: the
    whole problem on Mesh([device])). Each shard builds its landmarks'
    share of the reduced camera system, H, g and the cost summed over the
    mesh in one reduction an iteration; the relative-pose factors of
    `edges` (replicated, E << L) are added after the reduction, the
    replicated pose step is solved on the home device, and each shard
    back-substitutes its own landmarks. The candidate's cost is one scalar
    reduction. Returns (Tcw, Xw of every shard in shard order, cost) on the
    home device."""
    Tcw = shards[0].Tcw.to(mesh.home)
    K = Tcw.shape[0]
    dtype = Tcw.dtype
    fixed_kf = fixed_kf.to(mesh.home)
    obs = [_observations(pb, K) for pb in shards]
    if edges is not None:
        edges = BAEdges(*(t.to(mesh.home) for t in edges))
        ends = _edge_ends(edges, K)
    Xw = [pb.Xw for pb in shards]
    lam = torch.full((), lm_lambda0, dtype=dtype, device=mesh.home)
    cost = torch.full((), float("inf"), dtype=dtype, device=mesh.home)
    for _ in range(iterations):
        systems = [_landmark_system(cam, pb, ob, T_s, X_s, lam_s, huber_delta)
                   for pb, ob, T_s, X_s, lam_s in zip(shards, obs, mesh.replicate(Tcw), Xw,
                                                      mesh.replicate(lam))]
        # the (small) camera system reduced over the landmark shards
        H, g, cost = mesh.psum([sy[:3] for sy in systems])
        if edges is not None:
            He, ge, cost_e = _edge_system(Tcw, edges, ends, edge_huber)
            H = H + He
            g = g + ge
            cost = cost + cost_e
        xi = _pose_step(H, g, lam, fixed_kf)
        Xw_cand = [X_s + _landmark_step(pb, ob, sy[3], xi_s)
                   for pb, ob, sy, X_s, xi_s in zip(shards, obs, systems, Xw,
                                                    mesh.replicate(xi))]
        Tcw_cand = se3.exp(xi) @ Tcw
        if not adaptive:
            Tcw, Xw = Tcw_cand, Xw_cand
            continue
        cost_new = mesh.psum([_ba_cost(cam, T_s, X_s, pb, huber_delta, None, edge_huber)
                              for pb, T_s, X_s in zip(shards, mesh.replicate(Tcw_cand), Xw_cand)])
        if edges is not None:
            cost_new = cost_new + _edge_cost(Tcw_cand, edges, edge_huber)
        accept = cost_new < cost
        Xw = [torch.where(acc, Xc, X_s)
              for acc, Xc, X_s in zip(mesh.replicate(accept), Xw_cand, Xw)]
        Tcw, lam, cost = _lm_update(accept, lam, cost, cost_new, Tcw, Tcw_cand)
    return Tcw, mesh.gather(Xw), cost


def local_ba(cam: Camera, problem: BAProblem, fixed_kf: torch.Tensor, iterations: int = 5,
             huber_delta: float = 2.45, lm_lambda0: float = 1e-4,
             edges: Optional[BAEdges] = None, edge_huber: float = 1.0,
             adaptive: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Optimize keyframe poses and landmark positions (and, with `edges`,
    relative-pose factors: the joint pose-graph / landmark solve) by
    Levenberg-Marquardt: masked accept/reject of the joint (Tcw, Xw) step,
    the x2 / /3 lambda schedule (g2o Levenberg, Solver/PoseGraph.cpp:30-57);
    `adaptive=False` takes every step with fixed damping (Gauss-Newton).
    huber_delta = sqrt(5.991), the g2o convention.

    fixed_kf: (K,) bool gauge anchors. Returns (Tcw_opt (K, 4, 4),
    Xw_opt (L, 3), final cost ()), all on the problem's device, unread."""
    return _schur_lm(cam, (problem,), fixed_kf, Mesh([problem.Tcw.device]), iterations,
                     huber_delta, lm_lambda0, edges, edge_huber, adaptive)
