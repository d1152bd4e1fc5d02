"""PnP family: motion-only bundle adjustment and batched PnP RANSAC (port of
rgbdslam_tpu/solvers/pnp.py; the reference's off-live-path absolute-pose
solvers, SURVEY.md §2.4).

- `motion_only_ba` = Solver/PnPSolver.cpp: one SE(3) vertex, per-match
  reprojection edges with Huber delta = sqrt(5.991), 4 rounds of 10 damped
  Gauss-Newton iterations with chi^2 > 5.991 outlier demotion between
  rounds (Solver/PnPSolver.cpp:46-133); one 6x6 solve an iteration.
- `pnp_ransac` = Solver/PnPRansac.cpp: batched hypotheses from a minimal
  solver (Grunert P3P, EPnP on 4 points or the 6-point DLT), scored by
  reprojection error, the winner refit (EPnP over its consensus set, on
  request) and polished by `motion_only_ba`.

Every function takes leading batch dimensions where the JAX package maps
one over hypotheses with `vmap`. Nothing reads back to the host: the
results are device tensors, as JAX returns arrays. The symmetric
eigendecompositions of EPnP and the DLT are cyclic Jacobi sweeps written as
tensor code (`eigh_jacobi`), because `torch.linalg.eigh` reads its error
flags back to the host on the card; the small solves are
`torch.linalg.solve_ex`. Random draws come from a `torch.Generator` on the
points' device or are injected as `draws`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from rgbdslam_tpu_torch.device import upload
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.solvers.kabsch import weighted_rigid_transform
from rgbdslam_tpu_torch.solvers.ransac_se3 import draw_valid

CHI2_TH = 5.991  # Solver/PnPSolver.cpp:97,121 (95% 2-DoF chi-square)


def _project(cam: Camera, pts_c: torch.Tensor) -> torch.Tensor:
    z = torch.where(torch.abs(pts_c[..., 2]) < 1e-9, 1e-9, pts_c[..., 2])
    u = cam.fx * pts_c[..., 0] / z + cam.cx
    v = cam.fy * pts_c[..., 1] / z + cam.cy
    return torch.stack([u, v], dim=-1)


def reproj_residuals(cam: Camera, Tcw: torch.Tensor, Xw: torch.Tensor,
                     uv: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) pixel residuals of world points under Tcw."""
    return _project(cam, se3.transform_points(Tcw, Xw)) - uv


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for (..., k, k) and (..., k), with no host read."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def motion_only_ba(cam: Camera, Tcw_init: torch.Tensor, Xw: torch.Tensor, uv: torch.Tensor,
                   valid: torch.Tensor, rounds: int = 4, iters_per_round: int = 10):
    """Motion-only BA with Huber + chi^2 outlier demotion between rounds.

    Returns (Tcw_opt (4, 4), inlier mask (N,)). Mirrors PnPSolver::compute
    (Solver/PnPSolver.cpp:102-133): demoted matches leave the later rounds;
    the last round drops the robust kernel."""
    delta = CHI2_TH ** 0.5
    eye6 = 1e-6 * torch.eye(6, dtype=Tcw_init.dtype, device=Tcw_init.device)
    zero = torch.zeros((6,), dtype=Tcw_init.dtype, device=Tcw_init.device)

    def gn_iter(T, inl, use_huber):
        def res_fn(xi):
            # a leading dimension of one keeps exp's scalars one-dimensional:
            # under vmap a zero-dimensional tensor promotes to float64
            return reproj_residuals(cam, se3.exp(xi[None])[0] @ T, Xw, uv)

        J, r = torch.func.jacfwd(lambda x: (res_fn(x),) * 2, has_aux=True)(zero)
        r_norm = torch.linalg.norm(r, dim=-1)
        w = inl.to(T.dtype)
        if use_huber:
            w = torch.where(r_norm > delta, delta / torch.clamp_min(r_norm, 1e-9), 1.0) * w
        H = torch.einsum("nri,nrj,n->ij", J, J, w) + eye6
        g = torch.einsum("nri,nr,n->i", J, r, w)
        return se3.exp(-_solve(H, g)) @ T

    T = Tcw_init
    inl = valid
    for rd in range(rounds):
        for _ in range(iters_per_round):
            T = gn_iter(T, inl, rd < rounds - 1)     # kernel removed last round
        r = reproj_residuals(cam, T, Xw, uv)
        inl = valid & (torch.sum(r * r, dim=-1) <= CHI2_TH)  # PnPSolver.cpp:117-124
    return T, inl


# ---------------------------------------------------------------------------
# Batched minimal P3P (Grunert), the analog of the reference's opengv
# KNEIP/GAO/EPNP minimal absolute-pose selection (Solver/PnP.cpp:14-127):
# Grunert's distance quartic (Haralick et al. 1994), roots by Ferrari in
# complex64 with a Newton polish, as the JAX package computes them (powers
# written as the products jax's integer powers are).
# ---------------------------------------------------------------------------


def _cplx(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), complex(x), dtype=torch.complex64, device=like.device)


def _one_cubic_root(a, b, c):
    """One complex root of m^3 + a m^2 + b m + c (Cardano, complex64)."""
    p = b - a * a / 3.0
    q = c - a * b / 3.0 + 2.0 * (a * a * a) / 27.0
    hq, tp = q / 2.0, p / 3.0
    s = torch.sqrt(hq * hq + tp * tp * tp)
    u3a = -q / 2.0 + s
    u3b = -q / 2.0 - s
    u3 = torch.where(torch.abs(u3a) >= torch.abs(u3b), u3a, u3b)
    u3 = torch.where(torch.abs(u3) < 1e-20, _cplx(1e-20, u3), u3)
    u = u3 ** (1.0 / 3.0)
    return u - p / (3.0 * u) - a / 3.0


def _quartic_roots(b, c, d, e, newton: int = 3):
    """All four complex roots (..., 4) of x^4 + b x^3 + c x^2 + d x + e
    (Ferrari + `newton` polish steps: f32-grade coefficients need them)."""
    cb_, cc_, cd_, ce_ = (x.to(torch.complex64) for x in (b, c, d, e))
    cb2 = cb_ * cb_
    p = cc_ - 3.0 * cb_ * cb_ / 8.0
    q = cd_ - cb_ * cc_ / 2.0 + cb2 * cb_ / 8.0
    r = ce_ - cb_ * cd_ / 4.0 + cb2 * cc_ / 16.0 - 3.0 * (cb2 * cb2) / 256.0
    m = _one_cubic_root(p, p * p / 4.0 - r, -q * q / 8.0)
    s = torch.sqrt(2.0 * m)
    s = torch.where(torch.abs(s) < 1e-10, _cplx(1e-10, s), s)
    t1 = torch.sqrt(-(2.0 * p + 2.0 * m + 2.0 * q / s))
    t2 = torch.sqrt(-(2.0 * p + 2.0 * m - 2.0 * q / s))
    y = torch.stack([(s + t1) / 2.0, (s - t1) / 2.0, (-s + t2) / 2.0, (-s - t2) / 2.0],
                    dim=-1)
    x = y - cb_[..., None] / 4.0
    cb_, cc_, cd_, ce_ = (v[..., None] for v in (cb_, cc_, cd_, ce_))
    for _ in range(newton):
        f = (((x + cb_) * x + cc_) * x + cd_) * x + ce_
        fp = ((4.0 * x + 3.0 * cb_) * x + 2.0 * cc_) * x + cd_
        fp = torch.where(torch.abs(fp) < 1e-12, _cplx(1e-12, fp), fp)
        x = x - f / fp
    return x


def _triad(q1, q2):
    """Orthonormal frame (..., 3, 3) whose columns are q1's direction, q2's
    component orthogonal to it, and their cross product."""
    e1 = q1 / torch.clamp_min(torch.linalg.norm(q1, dim=-1, keepdim=True), 1e-12)
    q2p = q2 - torch.sum(q2 * e1, dim=-1, keepdim=True) * e1
    e2 = q2p / torch.clamp_min(torch.linalg.norm(q2p, dim=-1, keepdim=True), 1e-12)
    return torch.stack([e1, e2, torch.linalg.cross(e1, e2)], dim=-1)


def _p3p_grunert(fs: torch.Tensor, Pw: torch.Tensor):
    """Minimal 3-point absolute pose. fs: (..., 3, 3) unit bearing rays
    (camera frame), Pw: (..., 3, 3) world points. Returns (Tcw (..., 4, 4,
    4), valid (..., 4)): up to four solutions; the RANSAC consensus picks
    among them (as opengv's ransac does around Solver/PnP.cpp's KNEIP)."""
    f1, f2, f3 = fs[..., 0, :], fs[..., 1, :], fs[..., 2, :]
    P1, P2, P3 = Pw[..., 0, :], Pw[..., 1, :], Pw[..., 2, :]
    a2 = torch.sum((P2 - P3) ** 2, dim=-1)
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)
    ca = torch.sum(f2 * f3, dim=-1)   # angle at the camera between rays 2-3
    cb = torch.sum(f1 * f3, dim=-1)
    cg = torch.sum(f1 * f2, dim=-1)
    b2s = torch.clamp_min(b2, 1e-12)
    p = a2 / b2s
    q = c2 / b2s
    ca2, cb2, cg2, p2, q2 = ca * ca, cb * cb, cg * cg, p * p, q * q
    # Grunert quartic in v = s3/s1 (sympy resultant of the two
    # law-of-cosines constraints over u = s2/s1; overall sign irrelevant)
    A4 = (-4.0 * ca2 * q + p2 - 2.0 * p * q - 2.0 * p
          + q2 + 2.0 * q + 1.0)
    A3 = (8.0 * ca2 * cb * q + 4.0 * ca * cg * p + 4.0 * ca * cg * q
          - 4.0 * ca * cg - 4.0 * cb * p2 + 8.0 * cb * p * q
          + 4.0 * cb * p - 4.0 * cb * q2 - 4.0 * cb * q)
    A2 = (-4.0 * ca2 * q + 4.0 * ca2 - 8.0 * ca * cb * cg * p
          - 8.0 * ca * cb * cg * q + 4.0 * cb2 * p2
          - 8.0 * cb2 * p * q + 4.0 * cb2 * q2
          - 4.0 * cg2 * p + 4.0 * cg2 + 2.0 * p2
          - 4.0 * p * q + 2.0 * q2 - 2.0)
    A1 = (4.0 * ca * cg * p + 4.0 * ca * cg * q - 4.0 * ca * cg
          + 8.0 * cb * cg2 * p - 4.0 * cb * p2 + 8.0 * cb * p * q
          - 4.0 * cb * p - 4.0 * cb * q2 + 4.0 * cb * q)
    A0 = (-4.0 * cg2 * p + p2 - 2.0 * p * q + 2.0 * p
          + q2 - 2.0 * q + 1.0)
    A4s = torch.where(torch.abs(A4) < 1e-10, 1e-10, A4)
    roots = _quartic_roots(A3 / A4s, A2 / A4s, A1 / A4s, A0 / A4s)   # (..., 4)
    v = roots.real
    real_ok = torch.abs(roots.imag) < 1e-3 * (1.0 + torch.abs(v))
    ca, cb, cg, p, q = (x[..., None] for x in (ca, cb, cg, p, q))
    # u from the combination (i)-(ii) that cancels u^2
    gb = 1.0 + v * v - 2.0 * v * cb
    den = 2.0 * (cg - v * ca)
    den = torch.where(torch.abs(den) < 1e-9, 1e-9, den)
    u = (1.0 - v * v + (p - q) * gb) / den

    # joint Newton polish of (u, v) on the original two law-of-cosines
    # constraints, whose coefficients are f32-exact (the expanded quartic's
    # perturb its roots by up to a few cm of pose)
    for _ in range(3):
        g = 1.0 + v * v - 2.0 * v * cb
        F1 = u * u + v * v - 2.0 * u * v * ca - p * g
        F2 = 1.0 + u * u - 2.0 * u * cg - q * g
        J11 = 2.0 * u - 2.0 * v * ca
        J12 = 2.0 * v - 2.0 * u * ca - p * (2.0 * v - 2.0 * cb)
        J21 = 2.0 * u - 2.0 * cg
        J22 = -q * (2.0 * v - 2.0 * cb)
        det = J11 * J22 - J12 * J21
        det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
        u, v = u - (J22 * F1 - J12 * F2) / det, v - (-J21 * F1 + J11 * F2) / det

    gb = 1.0 + v * v - 2.0 * v * cb
    s1 = torch.sqrt(b2s[..., None] / torch.clamp_min(gb, 1e-12))
    s2 = u * s1
    s3 = v * s1
    valid = real_ok & (s1 > 0) & (s2 > 0) & (s3 > 0) & (gb > 1e-9)
    # camera-frame points from the recovered ray depths: (..., 4, 3, 3)
    Xc = torch.stack([s1[..., None] * f1[..., None, :], s2[..., None] * f2[..., None, :],
                      s3[..., None] * f3[..., None, :]], dim=-2)
    # exact triad alignment (R = [camera triad] [world triad]^T, t = Xc1 -
    # R P1): the iterative Horn fit under-converges on an exact triad
    Ew = _triad(P2 - P1, P3 - P1)[..., None, :, :]                   # (..., 1, 3, 3)
    Ec = _triad(Xc[..., 1, :] - Xc[..., 0, :], Xc[..., 2, :] - Xc[..., 0, :])
    Rm = Ec @ Ew.transpose(-1, -2)                                   # (..., 4, 3, 3)
    t = Xc[..., 0, :] - (Rm @ P1[..., None, :, None])[..., 0]
    return se3.from_Rt(Rm, t), valid


# ---------------------------------------------------------------------------
# Symmetric eigendecomposition without a host read: cyclic Jacobi in the
# round-robin order (each round rotates n/2 disjoint planes at once), batched.
# ---------------------------------------------------------------------------


@functools.lru_cache()
def _jacobi_rounds(n: int, dtype: torch.dtype, device: torch.device):
    """Per round: the (p, q) index tensors and their one-hot rows, put on
    `device` once through pinned memory (a copy from pageable host memory
    would make the host wait for the device)."""
    m = n + n % 2
    players = list(range(m))
    rounds = []
    eye = torch.eye(n, dtype=dtype, device=device)
    for _ in range(m - 1):
        pairs = [(players[i], players[m - 1 - i]) for i in range(m // 2)]
        pairs = np.array([(min(a), max(a)) for a in pairs if max(a) < n], np.int64)
        P, Q = upload(pairs[:, 0].copy(), device), upload(pairs[:, 1].copy(), device)
        rounds.append((P, Q, eye[P], eye[Q]))
        players = [players[0], players[-1]] + players[1:-1]
    return rounds


# Cyclic Jacobi sweeps of `eigh_jacobi`. The DLT's A^T A of six points seen
# from a camera a few metres from the world origin (condition ~1e9) reaches
# the float32 floor of its eigen-residual ||A v - lambda v|| / ||A|| (~2e-6)
# after 7 sweeps and stays 2e-5 above it after 6; EPnP's matrices converge
# in 5-7 (tests/test_torch_pnp.py::test_eigh_jacobi_converges). 8 leave a
# sweep to spare: a converged rotation is the identity to round-off.
JACOBI_SWEEPS = 8


def eigh_jacobi(A: torch.Tensor):
    """Eigenvalues (..., n) ascending and eigenvectors (..., n, n) (columns)
    of symmetric A (..., n, n): JACOBI_SWEEPS cyclic Jacobi sweeps, a stable
    sort, and each eigenvector's sign set so that its component of largest
    magnitude is positive (any eigensolver's signs are arbitrary; fixing
    them makes the result the same function on every device)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    V = eye.expand(A.shape)
    rounds = _jacobi_rounds(n, A.dtype, A.device)
    for _ in range(JACOBI_SWEEPS):
        A = 0.5 * (A + A.transpose(-1, -2))
        for P, Q, OP, OQ in rounds:
            app, aqq, apq = A[..., P, P], A[..., Q, Q], A[..., P, Q]
            zero = apq == 0
            theta = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
            t = torch.where(theta >= 0, 1.0, -1.0) / (
                torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
            t = torch.where(zero, 0.0, t)
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            # the rotation: c on (p, p) and (q, q), s on (p, q), -s on (q, p)
            J = (eye + torch.einsum("mi,...m,mj->...ij", OP, c - 1.0, OP)
                 + torch.einsum("mi,...m,mj->...ij", OQ, c - 1.0, OQ)
                 + torch.einsum("mi,...m,mj->...ij", OP, s, OQ)
                 - torch.einsum("mi,...m,mj->...ij", OQ, s, OP))
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    evals, order = torch.sort(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1, stable=True)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    lead = torch.gather(V, -2, torch.argmax(torch.abs(V), dim=-2, keepdim=True))
    return evals, V * torch.where(lead < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# EPnP (Lepetit, Moreno-Noguer, Fua, IJCV 2009), the >= 4-point closed form
# of the reference's opengv EPNP option: the pose through 4 control points,
# their camera-frame coordinates in the null space of a 2n x 12 system, the
# null-space mixing from the inter-control-point distances (3 closed-form
# seeds + Gauss-Newton), and a rigid fit world -> camera.
# ---------------------------------------------------------------------------

_EPNP_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


@functools.lru_cache()
def _epnp_pairs(device: torch.device):
    """The control-point pairs' two index tensors on `device`, put there
    once (indexing by a Python list copies it from pageable memory)."""
    pairs = np.array(_EPNP_PAIRS, np.int64)
    return upload(pairs[:, 0].copy(), device), upload(pairs[:, 1].copy(), device)


def _epnp_pose(Xw: torch.Tensor, uv_n: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """EPnP pose from S >= 4 weighted correspondences. Xw: (..., S, 3) world
    points, uv_n: (..., S, 2) normalized image coords, w: (..., S)
    nonnegative weights (0 = excluded, so it doubles as the consensus refit
    inside pnp_ransac). Returns Tcw (..., 4, 4)."""
    S = Xw.shape[-2]
    dtype, dev = Xw.dtype, Xw.device
    lead = Xw.shape[:-2]
    wn = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-12)

    # world control points: weighted centroid + principal axes (paper §3.1;
    # the floor keeps near-planar scenes solvable)
    c0 = torch.sum(wn[..., None] * Xw, dim=-2)
    Xc0 = Xw - c0[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", wn, Xc0, Xc0)
    evals, evecs = eigh_jacobi(cov)                                  # ascending
    sc = torch.sqrt(torch.clamp_min(evals, 1e-8))
    Cw = torch.stack([c0, c0 + sc[..., 2:3] * evecs[..., :, 2],
                      c0 + sc[..., 1:2] * evecs[..., :, 1],
                      c0 + sc[..., 0:1] * evecs[..., :, 0]], dim=-2)  # (..., 4, 3)

    # barycentric coordinates: [Cw^T; 1] alpha = [X; 1]
    ones4 = torch.ones(lead + (1, 4), dtype=dtype, device=dev)
    CT = torch.cat([Cw.transpose(-1, -2), ones4], dim=-2)            # (..., 4, 4)
    rhs = torch.cat([Xw.transpose(-1, -2), torch.ones(lead + (1, S), dtype=dtype,
                                                      device=dev)], dim=-2)
    alphas = torch.linalg.solve_ex(CT, rhs)[0].transpose(-1, -2)     # (..., S, 4)

    # M^T M of the 2S x 12 projection system, built per point
    x, y = uv_n[..., 0], uv_n[..., 1]
    z3 = torch.zeros_like(alphas)
    Mu = torch.stack([alphas, z3, -alphas * x[..., None]], dim=-1).reshape(lead + (S, 12))
    Mv = torch.stack([z3, alphas, -alphas * y[..., None]], dim=-1).reshape(lead + (S, 12))
    MtM = (torch.einsum("...n,...ni,...nj->...ij", w, Mu, Mu)
           + torch.einsum("...n,...ni,...nj->...ij", w, Mv, Mv))
    _ev, V12 = eigh_jacobi(MtM)
    V = V12[..., :, :4].transpose(-1, -2).reshape(lead + (4, 4, 3))  # null vecs as points

    ia, ib = _epnp_pairs(dev)
    dv = V[..., ia, :] - V[..., ib, :]                               # (..., 4, 6, 3)
    rho = torch.sum((Cw[..., ia, :] - Cw[..., ib, :]) ** 2, dim=-1)  # (..., 6)

    def col(i, j):
        """Column of L for beta_i beta_j: dv_i . dv_j (x2 off the diagonal)."""
        f = 1.0 if i == j else 2.0
        return f * torch.sum(dv[..., i, :, :] * dv[..., j, :, :], dim=-1)   # (..., 6)

    def ls(cols):
        """Least squares L[:, cols] b = rho."""
        A = torch.stack(cols, dim=-1)                                # (..., 6, k)
        k = A.shape[-1]
        AtA = A.transpose(-1, -2) @ A + 1e-9 * torch.eye(k, dtype=dtype, device=dev)
        return _solve(AtA, (A.transpose(-1, -2) @ rho[..., None])[..., 0])

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, 0.0))

    zero = torch.zeros(lead, dtype=dtype, device=dev)
    # seed 1: [b11, b12, b13, b14] (opencv find_betas_approx_1)
    b4 = ls([col(0, 0), col(0, 1), col(0, 2), col(0, 3)])
    s0 = torch.where(b4[..., 0] < 0, -1.0, 1.0)
    be1 = safe_sqrt(s0 * b4[..., 0])
    den = torch.clamp_min(be1, 1e-9)
    beta_a = torch.stack([be1, s0 * b4[..., 1] / den, s0 * b4[..., 2] / den,
                          s0 * b4[..., 3] / den], dim=-1)
    # seed 2: [b11, b12, b22] (opencv find_betas_approx_2)
    b3 = ls([col(0, 0), col(0, 1), col(1, 1)])
    be1 = safe_sqrt(torch.abs(b3[..., 0]))
    be2 = safe_sqrt(torch.abs(b3[..., 2])) * torch.where(b3[..., 1] >= 0, 1.0, -1.0)
    beta_b = torch.stack([be1, be2, zero, zero], dim=-1)
    # seed 3: [b11, b12, b22, b13, b23] (opencv find_betas_approx_3)
    b5 = ls([col(0, 0), col(0, 1), col(1, 1), col(0, 2), col(1, 2)])
    be1 = safe_sqrt(torch.abs(b5[..., 0]))
    be2 = safe_sqrt(torch.abs(b5[..., 2])) * torch.where(b5[..., 1] >= 0, 1.0, -1.0)
    be3 = b5[..., 3] / torch.clamp_min(be1, 1e-9)
    beta_c = torch.stack([be1, be2, be3, zero], dim=-1)

    eye4 = 1e-9 * torch.eye(4, dtype=dtype, device=dev)

    def gauss_newton(b):
        """5 GN steps on ||sum_k beta_k dv_k[pair]||^2 = rho (paper §3.4)."""
        for _ in range(5):
            cc = torch.einsum("...k,...kpi->...pi", b, dv)           # (..., 6, 3)
            res = torch.sum(cc * cc, dim=-1) - rho                   # (..., 6)
            J = 2.0 * torch.einsum("...pi,...kpi->...pk", cc, dv)    # (..., 6, 4)
            H = J.transpose(-1, -2) @ J + eye4
            b = b - _solve(H, (J.transpose(-1, -2) @ res[..., None])[..., 0])
        return b

    def pose_from_beta(beta):
        Cc = torch.einsum("...k,...kci->...ci", beta, V)             # (..., 4, 3)
        Xc = alphas @ Cc                                             # (..., S, 3)
        # cheirality: the null vector's sign is arbitrary
        zbar = torch.sum(wn * Xc[..., 2], dim=-1)
        Xc = torch.where((zbar < 0)[..., None, None], -Xc, Xc)
        T = weighted_rigid_transform(Xw, Xc, w)
        pr = Xc[..., :2] / torch.clamp_min(Xc[..., 2:3], 1e-9)
        err = torch.sum(wn * torch.sum((pr - uv_n) ** 2, dim=-1), dim=-1)
        return T, err

    best_T = torch.eye(4, dtype=dtype, device=dev).expand(lead + (4, 4))
    best_err = torch.full(lead, float("inf"), dtype=dtype, device=dev)
    for seed in (beta_a, beta_b, beta_c):
        T, err = pose_from_beta(gauss_newton(seed))
        take = err < best_err
        best_T = torch.where(take[..., None, None], T, best_T)
        best_err = torch.where(take, err, best_err)
    return best_T


def _dlt_pose(Xw: torch.Tensor, uv_n: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """6+-point DLT for [R|t] from world points and normalized image coords,
    then a polar-decomposition projection onto SO(3). Batched over leading
    dims. Xw: (..., S, 3), uv_n: (..., S, 2), w: (..., S)."""
    X = torch.cat([Xw, torch.ones(Xw.shape[:-1] + (1,), dtype=Xw.dtype, device=Xw.device)],
                  dim=-1)
    zero = torch.zeros_like(X)
    x, y = uv_n[..., 0:1], uv_n[..., 1:2]
    row_u = torch.cat([X, zero, -x * X], dim=-1)                     # (..., S, 12)
    row_v = torch.cat([zero, X, -y * X], dim=-1)
    A = torch.cat([row_u, row_v], dim=-2)                            # (..., 2S, 12)
    ws = torch.cat([w, w], dim=-1)[..., None]
    AtA = torch.einsum("...ni,...nj->...ij", A * ws, A)              # (..., 12, 12)
    # null vector = the eigenvector of the smallest eigenvalue
    _evals, evecs = eigh_jacobi(AtA)
    P = evecs[..., :, 0].reshape(evecs.shape[:-2] + (3, 4))
    # sign: the points' centroid must lie in front of the camera
    cent = torch.mean(Xw, dim=-2)
    zc = torch.einsum("...ij,...j->...i", P[..., :3], cent)[..., 2] + P[..., 2, 3]
    P = P * torch.where(zc < 0, -1.0, 1.0)[..., None, None]
    M = P[..., :3]
    t = P[..., 3]
    # scale: det(M)^(1/3) -> unit rotation
    det = torch.linalg.det(M)
    scale = torch.sign(det) * torch.abs(det) ** (1.0 / 3.0)
    scale = torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)
    M = M / scale[..., None, None]
    t = t / scale[..., None]
    # polar decomposition via Newton iteration: R <- (R + R^-T) / 2
    R = M
    for _ in range(6):
        R = 0.5 * (R + torch.linalg.inv_ex(R.transpose(-1, -2))[0])
    return se3.from_Rt(R, t)


class PnPResult(NamedTuple):
    Tcw: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor
    success: torch.Tensor


PNP_HYPOTHESES = 256
PNP_SAMPLE = {"p3p": 3, "epnp": 4, "dlt6": 6}


def pnp_ransac(
    cam: Camera,
    Xw: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    minimal: str = "p3p",
    refit: str = "ba",
    draws: Optional[torch.Tensor] = None,
) -> PnPResult:
    """Batched PnP RANSAC: minimal-solver hypotheses + reprojection scoring +
    motion-only BA refinement of the winner; no host read.

    minimal='p3p' (default): 3-point Grunert closed form, up to 4 poses a
    sample, all scored (the Solver/PnP.cpp:14-127 KNEIP/GAO class);
    'epnp': 4-point EPnP hypotheses; 'dlt6': the 6-point DLT. Defaults
    mirror Solver/PnPRansac.cpp:14-56: pixel threshold 3.0, H = 256 samples.
    refit='ba': motion-only BA on the winner's consensus set; 'epnp+ba':
    EPnP over the consensus set first, kept if it loses no inlier.

    The (H, S) sample indices are drawn by `generator` on the points'
    device, uniform over the valid slots, or injected as `draws` (JAX's
    `jax.random.categorical` indices, say)."""
    if minimal not in PNP_SAMPLE:
        raise ValueError(f"unknown minimal solver {minimal!r}")
    H = PNP_HYPOTHESES
    px_th = 3.0
    min_inliers = 10
    S = PNP_SAMPLE[minimal]
    if draws is None:
        if generator is None:
            raise ValueError("pnp_ransac needs a generator or injected draws")
        draws = draw_valid(valid, H, S, generator)
    idx = draws.to(torch.int64)
    any_valid = torch.any(valid)

    uv_n = torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy],
                       dim=-1)
    if minimal == "p3p":
        rays = torch.cat([uv_n, torch.ones(uv_n.shape[:-1] + (1,), dtype=uv_n.dtype,
                                           device=uv_n.device)], dim=-1)
        rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
        T_4, ok_4 = _p3p_grunert(rays[idx], Xw[idx])                 # (H, 4, 4, 4)
        T_h = T_4.reshape(-1, 4, 4)                                  # (4H, 4, 4)
        hyp_ok = ok_4.reshape(-1)
    else:
        fit = _epnp_pose if minimal == "epnp" else _dlt_pose
        T_h = fit(Xw[idx], uv_n[idx], valid[idx].to(Xw.dtype))
        hyp_ok = torch.ones(T_h.shape[:1], dtype=torch.bool, device=Xw.device)

    # batched residuals (H', N, 2)
    Xc = torch.einsum("hij,nj->hni", T_h[:, :3, :3], Xw) + T_h[:, None, :3, 3]
    err2 = torch.sum((_project(cam, Xc) - uv[None]) ** 2, dim=-1)
    inl_h = (err2 <= px_th * px_th) & valid[None, :] & (Xc[..., 2] > 0.05)
    cnt_h = torch.sum(inl_h, dim=-1) * hyp_ok
    # the winner (first on ties) by index_select: indexing by a
    # zero-dimensional tensor reads it back to the host
    best = torch.argmax(cnt_h).reshape(1)
    T0 = T_h.index_select(0, best)[0]
    inl0 = inl_h.index_select(0, best)[0]
    if refit == "epnp+ba":
        # non-minimal closed-form consensus refit before the BA polish
        T_e = _epnp_pose(Xw, uv_n, (inl0 & valid).to(Xw.dtype))
        Xc_e = Xw @ T_e[:3, :3].T + T_e[:3, 3]
        err2_e = torch.sum((_project(cam, Xc_e) - uv) ** 2, dim=-1)
        inl_e = (err2_e <= px_th * px_th) & valid & (Xc_e[..., 2] > 0.05)
        take = torch.sum(inl_e) >= torch.sum(inl0)
        T0 = torch.where(take, T_e, T0)
        inl0 = torch.where(take, inl_e, inl0)
    elif refit != "ba":
        raise ValueError(f"unknown refit {refit!r}")
    T_ref, inl_ref = motion_only_ba(cam, T0, Xw, uv, inl0 & valid)
    cnt = torch.sum(inl_ref)
    success = (cnt >= min_inliers) & any_valid
    return PnPResult(
        Tcw=torch.where(success, T_ref, torch.eye(4, dtype=T_ref.dtype, device=T_ref.device)),
        inliers=inl_ref & success,
        num_inliers=cnt.to(torch.int32),
        success=success,
    )
