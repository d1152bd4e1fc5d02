"""Batched 3D-3D RANSAC rigid registration under the RGB-D Mahalanobis noise
model or one of the PUT-style error models (port of
rgbdslam_tpu/solvers/ransac_se3.py; Solver/SolverSE3.cpp, Solver/Ransac.cpp).

1. draw H hypotheses of S samples, uniform over the valid slots;
2. fit all H transforms at once (batched Horn fit); slot 0 is the identity;
3. score all H x N residuals under `cfg.error_model`;
4. pick the best by (inlier count, error);
5. run `refine_iters` masked re-fits on the full inlier set;
6. with `cfg.mahalanobis_refine`, polish the result by whitened
   Gauss-Newton under the sensor covariance (`refine_mahalanobis_ref`),
   kept if it loses no inliers and no accuracy.

On CUDA tensors `ransac_se3` is `kernels.ransac_se3_fused`: steps 1-3 in
one kernel, 4-6 in a second (csrc/mahal.cu), three launches with the
uniform draws, whatever the model. On CPU tensors it is `ransac_se3_ref`, the plain version:
the same steps as tensor code, in two halves (`hypotheses_ref`,
`select_refine_ref`) that take and give what the two kernels take and give.

Sampling uses an explicit torch.Generator on the points' device (it cannot
reproduce jax.random's bits); `draws` injects the (H, S) sample indices
instead, so tests can hand both packages the same hypotheses.

Every function takes optional leading batch dimensions (the JAX package's
`vmap` over candidate keyframes, written out): points (..., N, 3), masks
(..., N), draws (..., H, S). A batch costs the same number of launches as
one problem.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from rgbdslam_tpu_torch.config import RansacConfig
from rgbdslam_tpu_torch.ops import kernels
from rgbdslam_tpu_torch.solvers.kabsch import weighted_rigid_transform


@dataclasses.dataclass
class RansacResult:
    T21: torch.Tensor          # (4, 4) best transform frame1 -> frame2 coords
    inliers: torch.Tensor      # (N,) bool final inlier mask
    num_inliers: torch.Tensor  # () int32
    rmse: torch.Tensor         # () f32 sqrt(mean m^2) over inliers
    success: torch.Tensor      # () bool num_inliers >= min_inliers


def _raster_cov(cfg: RansacConfig) -> Tuple[float, float]:
    rx = 3.0 * math.tan(math.radians(cfg.cam_angle_x) / cfg.cam_resol_x)
    ry = 3.0 * math.tan(math.radians(cfg.cam_angle_y) / cfg.cam_resol_y)
    return rx * rx, ry * ry


def _sigma_diag(z: torch.Tensor, cfg: RansacConfig) -> torch.Tensor:
    """Per-point diagonal covariance (..., 3) of the Khoshelham noise model
    (Solver/SolverSE3.cpp:216-297)."""
    raster_cov_x, raster_cov_y = _raster_cov(cfg)
    sz = cfg.depth_std_factor * z * z
    return torch.stack([raster_cov_x * z, raster_cov_y * z, sz * sz], dim=-1)


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    adj = torch.stack(
        [
            torch.stack([co_a, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([co_b, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([co_c, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _columns(T: torch.Tensor, p: torch.Tensor):
    """A function giving column i of points p (..., N, 3) shaped to broadcast
    against poses T (..., H..., 4, 4) as (..., H..., N)."""
    extra = (T.dim() - 2) - (p.dim() - 2)

    def col(x, i):
        c = x[..., i]
        return c.reshape(c.shape[:-1] + (1,) * extra + c.shape[-1:])
    return col


def _moved(T: torch.Tensor, p1: torch.Tensor):
    """q = R p1 + t as three (..., H..., N) planes, in the kernels' order."""
    col = _columns(T, p1)
    x = [col(p1, k) for k in range(3)]
    return [T[..., i, 0, None] * x[0] + T[..., i, 1, None] * x[1] + T[..., i, 2, None] * x[2]
            + T[..., i, 3, None] for i in range(3)]


def mahalanobis_sq_planes(T: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                          s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Squared Mahalanobis distance (..., N) of each correspondence under
    T (..., 4, 4), given the diagonal covariances s1, s2 (N, 3).

    d = R p1 + t - p2, C = R diag(s1) R^T + diag(s2) as six (..., N)
    planes, m^2 = d^T adj(C) d / det(C) clamped at 0 — in the operation
    order of the Pallas kernel and csrc/mahal.cu, so all three round alike.
    Points may carry leading batch dimensions (B..., N, 3); T then has the
    same ones, followed by any further dimensions (B..., H..., 4, 4)."""
    def r(i, j):
        return T[..., i, j, None]

    col = _columns(T, p1)
    x2, y2, z2 = col(p2, 0), col(p2, 1), col(p2, 2)
    s1 = torch.stack([col(s1, 0), col(s1, 1), col(s1, 2)], dim=-1)
    s2 = torch.stack([col(s2, 0), col(s2, 1), col(s2, 2)], dim=-1)
    q = _moved(T, p1)
    d1, d2, d3 = q[0] - x2, q[1] - y2, q[2] - z2

    def centry(i, j):
        c = (r(i, 0) * r(j, 0) * s1[..., 0] + r(i, 1) * r(j, 1) * s1[..., 1]
             + r(i, 2) * r(j, 2) * s1[..., 2])
        return c + s2[..., i] if i == j else c

    a, b, c = centry(0, 0), centry(0, 1), centry(0, 2)
    d, e, f = centry(1, 1), centry(1, 2), centry(2, 2)
    A11 = d * f - e * e
    A12 = c * e - b * f
    A13 = b * e - c * d
    A22 = a * f - c * c
    A23 = b * c - a * e
    A33 = a * d - b * b
    det = a * A11 + b * A12 + c * A13
    quad = (A11 * d1 * d1 + A22 * d2 * d2 + A33 * d3 * d3
            + 2.0 * (A12 * d1 * d2 + A13 * d1 * d3 + A23 * d2 * d3))
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    return torch.clamp_min(quad * inv_det, 0.0)


def mahalanobis_sq(T21: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                   cfg: RansacConfig) -> torch.Tensor:
    """Squared Mahalanobis distance (..., N) under T21 (errorFunction2,
    Solver/SolverSE3.cpp:216-280)."""
    return mahalanobis_sq_planes(T21, p1, p2, _sigma_diag(p1[..., 2], cfg),
                                 _sigma_diag(p2[..., 2], cfg))


def _rmse(cnt: torch.Tensor, err_sum: torch.Tensor) -> torch.Tensor:
    # meanError semantics (Solver/SolverSE3.cpp:206-213): <3 inliers -> huge
    return torch.where(cnt >= 3, torch.sqrt(err_sum / torch.clamp_min(cnt, 1)), 1e9)


def check_model(cfg: RansacConfig, cam=None) -> None:
    """Raise for an unknown error model, and for a reprojection model
    without a camera (rgbdslam_tpu/solvers/ransac_se3.py:164-165)."""
    if cfg.error_model not in kernels.ERROR_MODELS:
        raise ValueError(f"unknown error_model {cfg.error_model!r}")
    if cfg.error_model in ("reprojection", "both") and cam is None:
        raise ValueError(f"error_model={cfg.error_model!r} requires a camera")


def pair_errors(T: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                cfg: RansacConfig, cam=None):
    """(inlier test (..., N) bool before the validity mask, error (..., N))
    of each correspondence under poses T, as `_score` of the JAX package
    (rgbdslam_tpu/solvers/ransac_se3.py:146-189) and csrc/mahal.cu's
    pair_inlier: m^2 under mahalanobis; else delta^2 with delta = |R p1 + t
    - p2| rounded as a root, and the model's distance or pixel test. Shapes
    as `mahalanobis_sq_planes`."""
    check_model(cfg, cam)
    if cfg.error_model == "mahalanobis":
        m2 = mahalanobis_sq(T, p1, p2, cfg)
        return m2 <= cfg.max_mahalanobis * cfg.max_mahalanobis, m2
    col = _columns(T, p1)
    q = _moved(T, p1)
    d = [q[k] - col(p2, k) for k in range(3)]
    delta = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    model = cfg.error_model
    if model == "euclidean":
        ok = delta <= cfg.inlier_threshold_m
    elif model == "adaptive_euclidean":
        z_mean = 0.5 * (col(p1, 2) + col(p2, 2))
        ok = delta <= cfg.inlier_threshold_m + cfg.adaptive_depth_coeff * z_mean * z_mean
    else:
        zq = torch.clamp_min(q[2], 1e-6)
        zt = torch.clamp_min(col(p2, 2), 1e-6)
        du = (cam.fx * q[0] / zq + cam.cx) - (cam.fx * col(p2, 0) / zt + cam.cx)
        dv = (cam.fy * q[1] / zq + cam.cy) - (cam.fy * col(p2, 1) / zt + cam.cy)
        ok = torch.sqrt(du * du + dv * dv) <= cfg.reproj_threshold_px
        if model == "both":
            ok = ok & (delta <= cfg.inlier_threshold_m)
    return ok, delta * delta


def _score(T: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
           valid: torch.Tensor, cfg: RansacConfig, cam=None):
    """Inlier mask, count and rmse for one transform per problem, T
    (..., 4, 4) with points (..., N, 3), under `cfg.error_model`."""
    ok, err = pair_errors(T, p1, p2, cfg, cam)
    inl = ok & valid
    cnt = torch.sum(inl, dim=-1)
    err_sum = torch.sum(torch.where(inl, err, 0.0), dim=-1)
    return inl, cnt, _rmse(cnt, err_sum)


def _chol3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 Cholesky (lower), each pivot floored at 1e-20
    before its root (the JAX package's _chol3)."""
    a11 = torch.sqrt(torch.clamp_min(A[..., 0, 0], 1e-20))
    l21 = A[..., 1, 0] / a11
    l31 = A[..., 2, 0] / a11
    a22 = torch.sqrt(torch.clamp_min(A[..., 1, 1] - l21 * l21, 1e-20))
    l32 = (A[..., 2, 1] - l31 * l21) / a22
    a33 = torch.sqrt(torch.clamp_min(A[..., 2, 2] - l31 * l31 - l32 * l32, 1e-20))
    zero = torch.zeros_like(a11)
    return torch.stack([torch.stack([a11, zero, zero], dim=-1),
                        torch.stack([l21, a22, zero], dim=-1),
                        torch.stack([l31, l32, a33], dim=-1)], dim=-2)


def refine_mahalanobis_ref(T0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                           inliers: torch.Tensor, cfg: RansacConfig,
                           iterations: int = 5) -> torch.Tensor:
    """Anisotropic Gauss-Newton polish (rgbdslam_tpu/solvers/ransac_se3.py
    refine_mahalanobis, 211-260) over leading batch dimensions: minimise the
    whitened residuals L^-1 (R p1 + t - p2), L L^T = R diag(s1) R^T +
    diag(s2), over the inliers; `iterations` rounds of H + 1e-6 I solved
    with pivoting and a left exp-compose. Returns the polished pose where
    it is finite and there are >= 3 inliers, else T0."""
    from rgbdslam_tpu_torch.geometry import se3

    s1 = _sigma_diag(p1[..., 2], cfg)
    s2 = _sigma_diag(p2[..., 2], cfg)
    eye = torch.eye(3, dtype=T0.dtype, device=T0.device)
    cov1 = s1[..., :, :, None] * eye
    cov2 = s2[..., :, :, None] * eye
    wm = inliers.to(T0.dtype)
    T = T0
    for _ in range(iterations):
        R = T[..., :3, :3]
        q = torch.einsum("...ij,...nj->...ni", R, p1) + T[..., None, :3, 3]
        delta = q - p2
        cov = torch.einsum("...ij,...njk,...lk->...nil", R, cov1, R) + cov2
        L = _chol3(cov)
        Wd = torch.linalg.solve_triangular(L, delta[..., None], upper=False)[..., 0]
        Jr = torch.cat([eye.expand(q.shape[:-1] + (3, 3)), -se3.hat(q)], dim=-1)
        WJ = torch.linalg.solve_triangular(L, Jr, upper=False)
        H = torch.einsum("...nij,...nik,...n->...jk", WJ, WJ, wm) + 1e-6 * torch.eye(
            6, dtype=T.dtype, device=T.device)
        g = torch.einsum("...nij,...ni,...n->...j", WJ, Wd, wm)
        xi = -torch.linalg.solve_ex(H, g[..., None])[0][..., 0]
        T = se3.exp(xi) @ T
    ok = torch.isfinite(T).all(dim=-1).all(dim=-1) & (torch.sum(wm, dim=-1) >= 3)
    return torch.where(ok[..., None, None], T, T0)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx[...], :] per batch entry: x (..., N) or (..., N, 3) with
    idx (..., H, S) int64 -> (..., H, S) or (..., H, S, 3)."""
    if idx.dim() == 2:
        return x[idx]
    lead = idx.shape[:-2]
    flat = idx.reshape(lead + (-1,))
    if x.dim() == len(lead) + 1:
        return torch.gather(x, -1, flat).reshape(idx.shape)
    flat = flat[..., None].expand(lead + (flat.shape[-1], x.shape[-1]))
    return torch.gather(x, -2, flat).reshape(idx.shape + (x.shape[-1],))


def _uniforms(p1, cfg: RansacConfig, generator, draws) -> Optional[torch.Tensor]:
    """The (..., H, S) uniforms of one call, None where draws are injected."""
    if draws is not None:
        return None
    if generator is None:
        raise ValueError("ransac_se3 needs a generator or injected draws")
    return torch.rand(p1.shape[:-2] + (cfg.num_hypotheses, cfg.sample_size),
                      generator=generator, device=p1.device)


def _valid_slots(valid: torch.Tensor):
    """(cand (..., N) int64, n_valid (...,)): the indices of the valid slots
    packed to the front, and their count floored at 1."""
    n = valid.shape[-1]
    lead = valid.shape[:-1]
    dev = valid.device
    pos = torch.cumsum(valid.to(torch.int64), -1) - 1
    # compact the valid indices; invalid slots write to the extra slot n,
    # which is dropped (the JAX scatter's mode="drop")
    slot = torch.where(valid, pos, n)
    cand = torch.zeros(lead + (n + 1,), dtype=torch.int64, device=dev)
    cand = cand.scatter(
        -1, slot, torch.arange(n, dtype=torch.int64, device=dev).expand(lead + (n,))
    )[..., :n]
    return cand, torch.clamp_min(torch.sum(valid.to(torch.int64), dim=-1), 1)


def draw_valid(valid: torch.Tensor, num_hypotheses: int, sample_size: int,
               generator: torch.Generator) -> torch.Tensor:
    """(H, S) int64 indices of valid slots of `valid` (N,), uniform with
    replacement, drawn on the generator's device with no host read (the
    draws of JAX's `jax.random.choice(p=valid / n_valid)`, not its bits).
    With no valid slot every draw is 0."""
    cand, n_valid = _valid_slots(valid)
    u = torch.rand((num_hypotheses, sample_size), generator=generator, device=valid.device)
    k = torch.minimum(torch.floor(u * n_valid).to(torch.int64), n_valid - 1)
    return cand[k]


def hypothesis_fits_ref(p1, p2, w, valid, num_hypotheses: int, u=None, draws=None):
    """T_h (..., H, 4, 4): compact the valid slots, turn the uniforms `u`
    (..., H, S) into draws (or take `draws`), fit the H hypotheses; slot 0
    is the identity. In the points' dtype (float64 gives the fits' rounding
    a yardstick)."""
    dev = p1.device
    cand, n_valid = _valid_slots(valid)
    if draws is None:
        nv = n_valid[..., None, None]
        draws = torch.minimum(torch.floor(u * nv).to(torch.int64), nv - 1)
    idx = _take(cand, draws.to(torch.int64))

    sp1 = _take(p1, idx)                           # (..., H, S, 3)
    sp2 = _take(p2, idx)
    sw = _take(w, idx) * _take(valid, idx)
    T_h = weighted_rigid_transform(sp1, sp2, sw)   # (..., H, 4, 4)
    # hypothesis 0 = identity (identity fallback, Solver/SolverSE3.cpp:105-117)
    T_h[..., 0, :, :] = torch.eye(4, dtype=T_h.dtype, device=dev)
    return T_h


def hypotheses_ref(p1, p2, w, valid, cfg: RansacConfig, u=None, draws=None, cam=None):
    """First half of the plain version: the H fitted hypotheses and their
    scores. Returns (T_h (..., H, 4, 4), count (..., H) int32, sum of errors
    over inliers (..., H)): the plain scorer K3's under mahalanobis, the
    model's `pair_errors` under the others."""
    T_h = hypothesis_fits_ref(p1, p2, w, valid, cfg.num_hypotheses, u=u, draws=draws)
    if cfg.error_model == "mahalanobis":
        cnt_h, err_h = kernels.mahal_hypothesis_scores_ref(
            T_h, p1, p2, _sigma_diag(p1[..., 2], cfg), _sigma_diag(p2[..., 2], cfg), valid,
            cfg.max_mahalanobis * cfg.max_mahalanobis)
        return T_h, cnt_h, err_h
    ok, err = pair_errors(T_h, p1, p2, cfg, cam)
    inl = ok & valid[..., None, :]
    return (T_h, torch.sum(inl, dim=-1).to(torch.int32),
            torch.sum(torch.where(inl, err, 0.0), dim=-1))


def select_refine_ref(T_h, cnt_h, err_h, p1, p2, w, valid,
                      cfg: RansacConfig, cam=None) -> RansacResult:
    """Second half of the plain version: the lexicographic winner of the
    scored hypotheses, its score, `refine_iters` masked refits and, with
    `cfg.mahalanobis_refine`, the polish."""
    lead = p1.shape[:-2]
    rmse_h = _rmse(cnt_h, err_h)
    # lexicographic best: max inliers, then min error (first index on ties)
    rank = cnt_h.to(torch.float32) * 1e4 - torch.clamp_max(rmse_h, 9e3)
    best = torch.argmax(rank, dim=-1)
    T = torch.take_along_dim(
        T_h, best[..., None, None, None].expand(lead + (1, 4, 4)), dim=-3
    )[..., 0, :, :]
    inl, cnt, rmse = _score(T, p1, p2, valid, cfg, cam)

    def keep_better(T_new, T, inl, cnt, rmse):
        # keep a refit only if it loses no inliers and no accuracy
        # (Solver/SolverSE3.cpp:72)
        inl2, cnt2, rmse2 = _score(T_new, p1, p2, valid, cfg, cam)
        better = (cnt2 >= cnt) & (rmse2 <= rmse)
        return (torch.where(better[..., None, None], T_new, T),
                torch.where(better[..., None], inl2, inl), torch.where(better, cnt2, cnt),
                torch.where(better, rmse2, rmse))

    # masked refinement re-fits on the full inlier set
    # (Solver/SolverSE3.cpp:61-84 refine-until-stable, fixed-trip here)
    for _ in range(cfg.refine_iters):
        inl, cnt, rmse = _score(T, p1, p2, valid, cfg, cam)
        T_new = weighted_rigid_transform(p1, p2, w * inl.to(w.dtype))
        T, inl, cnt, rmse = keep_better(T_new, T, inl, cnt, rmse)
    if cfg.mahalanobis_refine:
        T_m = refine_mahalanobis_ref(T, p1, p2, inl, cfg, cfg.mahalanobis_refine_iters)
        T, inl, cnt, rmse = keep_better(T_m, T, inl, cnt, rmse)

    success = (cnt >= cfg.min_inliers) & torch.any(valid, dim=-1)
    return RansacResult(T21=T, inliers=inl & success[..., None],
                        num_inliers=cnt.to(torch.int32), rmse=rmse,
                        success=success)


def ransac_se3_ref(
    p1: torch.Tensor,
    p2: torch.Tensor,
    w: torch.Tensor,
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    cfg: RansacConfig = RansacConfig(),
    draws: Optional[torch.Tensor] = None,
    cam=None,
) -> RansacResult:
    """Plain version of `ransac_se3` (same arguments, same result): tensor
    code on whatever device the points lie on, a few thousand small ops,
    scored by the plain scorer (it launches no kernel)."""
    check_model(cfg, cam)
    u = _uniforms(p1, cfg, generator, draws)
    T_h, cnt_h, err_h = hypotheses_ref(p1, p2, w, valid, cfg, u=u, draws=draws, cam=cam)
    return select_refine_ref(T_h, cnt_h, err_h, p1, p2, w, valid, cfg, cam)


def ransac_se3_cuda(p1, p2, w, valid, cfg: RansacConfig, u=None, draws=None, cam=None):
    """`ransac_se3` for CUDA tensors through `kernels.ransac_se3_fused`,
    from the uniforms `u` (..., H, S) or the injected `draws`. Returns the
    result and kernel A's (T_h, count, sum of errors), which are what
    `hypotheses_ref` returns."""
    check_model(cfg, cam)
    n = p1.shape[-2]
    lead = p1.shape[:-2]
    H, S = cfg.num_hypotheses, cfg.sample_size
    flat = lead if len(lead) < 2 else (-1,)      # the kernels take one batch dimension
    if draws is None:
        u = u.reshape(flat + (H, S))
    else:
        u, draws = None, draws.to(torch.int32).reshape(flat + (H, S)).contiguous()
    cov_x, cov_y = _raster_cov(cfg)
    fx, fy, cx, cy = (0.0,) * 4 if cam is None else (cam.fx, cam.fy, cam.cx, cam.cy)
    params = (cov_x, cov_y, cfg.depth_std_factor, cfg.max_mahalanobis * cfg.max_mahalanobis,
              cfg.inlier_threshold_m, cfg.adaptive_depth_coeff, cfg.reproj_threshold_px,
              fx, fy, cx, cy)
    out, hyp = kernels.ransac_se3_fused(
        p1.reshape(flat + (n, 3)).contiguous(), p2.reshape(flat + (n, 3)).contiguous(),
        w.reshape(flat + (n,)).contiguous(), valid.reshape(flat + (n,)).contiguous(),
        u, draws, H, S, cfg.error_model, params, cfg.refine_iters, cfg.min_inliers,
        cfg.mahalanobis_refine_iters if cfg.mahalanobis_refine else 0)
    T, inl, cnt, rmse, success = out
    res = RansacResult(T21=T.reshape(lead + (4, 4)), inliers=inl.reshape(lead + (n,)),
                       num_inliers=cnt.reshape(lead), rmse=rmse.reshape(lead),
                       success=success.reshape(lead))
    T_h, cnt_h, err_h = hyp
    return res, (T_h.reshape(lead + (H, 4, 4)), cnt_h.reshape(lead + (H,)),
                 err_h.reshape(lead + (H,)))


def ransac_se3(
    p1: torch.Tensor,
    p2: torch.Tensor,
    w: torch.Tensor,
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    cfg: RansacConfig = RansacConfig(),
    draws: Optional[torch.Tensor] = None,
    cam=None,
) -> RansacResult:
    """Estimate T21 with p2 ~= T21 * p1 from masked correspondences.

    p1, p2: (N, 3) matched camera-frame points; w: (N,) fit weights
    (1/(z1*z2), Solver/SolverSE3.cpp:174), zero for invalid slots; valid:
    (N,) bool. `generator` draws the samples on the points' device;
    `draws` (H, S) int, uniform in [0, number of valid slots), replaces it.
    With leading batch dimensions on every argument ((B, N, 3), (B, N),
    draws (B, H, S)) each entry is an independent problem and every field
    of the result gains the batch dimension. Nothing here copies to the
    host. `cam` (a Camera) is read by the reprojection error models, which
    raise ValueError without one. The fused kernels for CUDA tensors, the
    plain version for CPU tensors."""
    if kernels.on_cuda(p1, p2, w, valid):
        return ransac_se3_cuda(p1, p2, w, valid, cfg, _uniforms(p1, cfg, generator, draws),
                               draws, cam)[0]
    return ransac_se3_ref(p1, p2, w, valid, generator, cfg, draws, cam)
