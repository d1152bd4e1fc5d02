"""Plane-to-plane GICP refinement over matched keypoints, its surface
covariances (depth patches or the k nearest neighbours of each matched set)
and point-to-plane ICP (port of rgbdslam_tpu/solvers/icp.py).

Warm-started from the RANSAC transform, `gicp_refine` refines T21 so that
R p1 + t ~= p2, keeping the descriptor pairing (or, with
IcpConfig.reassociate, re-pairing every point with its nearest valid target
each round, PCL's behaviour) and gating each pair by max_correspondence_dist
per round (Solver/Gicp.cpp:37-66, System/Tracking.cpp:148-149). On CUDA the
whole of it (Gauss-Newton loop, convergence gate, fallback) is one launch of
kernel K4 (ops/kernels.py); on the CPU it is the plain loop and
`_finish_gicp`. `knn_covariances` and `point_to_plane_icp` were XLA code in
the JAX package, not Pallas kernels: here they are tensor code on either
device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rgbdslam_tpu_torch.config import IcpConfig
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.ops import image as image_ops
from rgbdslam_tpu_torch.ops import kernels


def knn_covariances(pts: torch.Tensor, valid: torch.Tensor, k: int = 8,
                    epsilon: float = 1e-3) -> torch.Tensor:
    """GICP-style regularized covariance (N, 3, 3) of each point from its k
    nearest valid neighbours in the same set (the point itself and invalid
    pairs excluded; ties to the lower index, by a stable descending sort of
    -d^2 where the JAX package takes approx_max_k, exact on the CPU), centred
    in two passes, with the soft floor C + eps * max(tr C, 1e-4) / 3 * I."""
    n = pts.shape[0]
    d2 = torch.sum((pts[:, None, :] - pts[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(valid[None, :] & valid[:, None], d2, float("inf"))
    d2 = d2.masked_fill(torch.eye(n, dtype=torch.bool, device=pts.device), float("inf"))
    neg, idx = torch.sort(-d2, dim=-1, descending=True, stable=True)
    neg, idx = neg[:, :k], idx[:, :k]
    nbr = pts[idx]                                             # (N, k, 3)
    w = torch.isfinite(-neg).to(pts.dtype)
    wsum = torch.clamp_min(w.sum(-1, keepdim=True), 1.0)
    mean = torch.sum(nbr * w[..., None], dim=1) / wsum
    cent = (nbr - mean[:, None, :]) * w[..., None]
    C = torch.einsum("nki,nkj->nij", cent, cent) / wsum[..., None]
    tr = C[:, 0, 0] + C[:, 1, 1] + C[:, 2, 2]
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    return C + (epsilon * torch.clamp_min(tr, 1e-4) / 3.0)[..., None, None] * eye


def nearest_targets(q: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N,) index of each q's nearest valid p2 (first index on ties, 0 where
    none is valid): the re-pairing of IcpConfig.reassociate, with |q - p2|^2
    summed as (dx^2 + dy^2) + dz^2 as K4 sums it."""
    d = q[:, None, :] - p2[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return torch.argmin(torch.where(valid[None, :], d2, float("inf")), dim=1)


def depth_patch_covariances(cam: Camera, depth: torch.Tensor, uv: torch.Tensor,
                            radius: int = 2, epsilon: float = 1e-3) -> torch.Tensor:
    """Per-keypoint surface covariance (N, 3, 3) from the backprojected
    (2r+1)^2 depth patch around each keypoint, with the soft eigenvalue
    floor C + eps * max(tr C, 1e-4) / 3 * I. Invalid-depth pixels are
    masked; dense moment maps are box-summed and read at the keypoints."""
    h, w = depth.shape
    ok = (depth > 0).to(depth.dtype)
    col = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :].expand(h, w)
    row = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None].expand(h, w)
    x = (col - cam.cx) / cam.fx * depth
    y = (row - cam.cy) / cam.fy * depth
    z = depth

    def at(img):
        return image_ops.nearest_sample(img, uv)

    def moment(a):
        return at(image_ops.box_filter_sum(a * ok, radius))

    nn = at(torch.clamp_min(image_ops.box_filter_sum(ok, radius), 1.0))
    mx, my, mz = moment(x) / nn, moment(y) / nn, moment(z) / nn
    Cxx = moment(x * x) / nn - mx * mx
    Cxy = moment(x * y) / nn - mx * my
    Cxz = moment(x * z) / nn - mx * mz
    Cyy = moment(y * y) / nn - my * my
    Cyz = moment(y * z) / nn - my * mz
    Czz = moment(z * z) / nn - mz * mz
    C = torch.stack([
        torch.stack([Cxx, Cxy, Cxz], dim=-1),
        torch.stack([Cxy, Cyy, Cyz], dim=-1),
        torch.stack([Cxz, Cyz, Czz], dim=-1),
    ], dim=-2)
    tr = Cxx + Cyy + Czz
    eye = torch.eye(3, dtype=depth.dtype, device=depth.device)
    return C + (epsilon * torch.clamp_min(tr, 1e-4) / 3.0)[..., None, None] * eye


def _gn_step(T, p1, p2, W, valid, max_dist):
    """One Gauss-Newton step for min sum r^T W r, r = R p1 + t - p2, with
    the left increment T <- exp(xi) T and J = [I | -hat(R p1 + t)].
    Returns (T_new, cost, gated count)."""
    R = T[:3, :3]
    t = T[:3, 3]
    q = p1 @ R.T + t
    r = q - p2
    dist = torch.linalg.norm(r, dim=-1)
    wm = (valid & (dist < max_dist)).to(T.dtype)
    Jrot = -se3.hat(q)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(Jrot.shape)
    J = torch.cat([eye, Jrot], dim=-1)                        # (N, 3, 6)
    WJ = W @ J
    H = torch.einsum("nij,nik,n->jk", J, WJ, wm)
    b = torch.einsum("nij,ni,n->j", WJ, r, wm)
    H = H + 1e-6 * torch.eye(6, dtype=T.dtype, device=T.device)
    xi = -torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
    T_new = se3.exp(xi) @ T
    cost = torch.sum(torch.einsum("ni,nij,nj->n", r, W, r) * wm)
    return T_new, cost, torch.sum(wm)


def gicp_refine(
    p1: torch.Tensor,
    p2: torch.Tensor,
    valid: torch.Tensor,
    T_init: torch.Tensor,
    cfg: IcpConfig = IcpConfig(),
    C1: torch.Tensor | None = None,
    C2: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plane-to-plane refinement of T21 over matched camera-frame points.

    C1, C2: (N, 3, 3) surface covariances (depth_patch_covariances); either
    left None is computed from its set by `knn_covariances` (the PCL GICP
    behaviour). With cfg.reassociate each round re-pairs every point with
    its nearest valid target and indexes C2 alike. Returns (T21, converged
    bool, matched count int32); an under-constrained or non-finite result
    falls back to T_init (Solver/Gicp.cpp:23)."""
    if C1 is None:
        C1 = knn_covariances(p1, valid, epsilon=cfg.gicp_epsilon)
    if C2 is None:
        C2 = knn_covariances(p2, valid, epsilon=cfg.gicp_epsilon)
    if kernels.on_cuda(T_init, p1, p2, C1, C2, valid):
        return kernels.gicp_refine_fused(
            T_init, p1, p2, C1, C2, valid, cfg.max_iterations,
            cfg.max_correspondence_dist, cfg.min_matches, reassociate=cfg.reassociate)[0]
    T_fin, _cost, _cnt = kernels.gicp_refine_ref(
        T_init, p1, p2, C1, C2, valid, cfg.max_iterations,
        cfg.max_correspondence_dist, reassociate=cfg.reassociate)
    return _finish_gicp(T_fin, T_init, p1, p2, valid, cfg)


def gicp_normal_equations(T: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                          C1: torch.Tensor, C2: torch.Tensor, valid: torch.Tensor,
                          cfg: IcpConfig = IcpConfig()):
    """One plane-to-plane Gauss-Newton build at pose T: (H (6, 6), b (6,),
    cost (), gated count ()), the undamped normal equations of one round of
    `gicp_refine` (the JAX package's `gicp_gn_normal_equations`). Kernel K5
    for CUDA tensors, its plain version for CPU tensors."""
    if kernels.on_cuda(T, p1):
        return kernels.gicp_gn_normal_equations(
            T.contiguous(), p1.contiguous(), p2.contiguous(), C1.contiguous(),
            C2.contiguous(), valid.contiguous(), cfg.max_correspondence_dist)
    return kernels.gicp_gn_normal_equations_ref(T, p1, p2, C1, C2, valid,
                                                cfg.max_correspondence_dist)


def _finish_gicp(T_fin, T_init, p1, p2, valid, cfg: IcpConfig):
    """Convergence gate + fallback: enough valid pairs, enough gated pairs
    at the final pose, and a finite result. The plain version of what
    `kernels.gicp_refine_fused` does after its loop; with cfg.reassociate
    each point is paired with its nearest valid target at the final pose."""
    n_valid = torch.sum(valid)
    enough = n_valid >= cfg.min_matches
    q = p1 @ T_fin[:3, :3].T + T_fin[:3, 3]
    if cfg.reassociate:
        p2 = p2[nearest_targets(q, p2, valid)]
    gated = valid & (torch.linalg.norm(q - p2, dim=-1) < cfg.max_correspondence_dist)
    converged = enough & (torch.sum(gated) >= cfg.min_matches)
    converged = converged & torch.isfinite(T_fin).all()
    T_out = torch.where(converged, T_fin, T_init)
    return T_out, converged, n_valid.to(torch.int32)


def point_to_plane_icp(src_pts: torch.Tensor, dst_pts: torch.Tensor,
                       dst_normals: torch.Tensor, T_init: torch.Tensor, iters: int = 10,
                       max_dist: float = 0.25) -> torch.Tensor:
    """Dense point-to-plane ICP with given correspondences (the JAX
    package's point_to_plane_icp): src_pts / dst_pts (N, 3), invalid where
    z <= 0, dst_normals (N, 3); `iters` Gauss-Newton rounds of min sum
    ((R s + t - d) . n)^2 over the pairs with |r| < max_dist, J = [n | q x n]
    for the left increment, H + 1e-6 I. Returns T (4, 4)."""
    valid = (src_pts[:, 2] > 0) & (dst_pts[:, 2] > 0)
    eye6 = 1e-6 * torch.eye(6, dtype=T_init.dtype, device=T_init.device)
    T = T_init
    for _ in range(iters):
        q = src_pts @ T[:3, :3].T + T[:3, 3]
        r = torch.sum((q - dst_pts) * dst_normals, dim=-1)
        wm = (valid & (torch.abs(r) < max_dist)).to(T.dtype)
        Jr = torch.cat([dst_normals, torch.linalg.cross(q, dst_normals)], dim=-1)
        H = torch.einsum("ni,nj,n->ij", Jr, Jr, wm) + eye6
        b = torch.einsum("ni,n,n->i", Jr, r, wm)
        xi = -torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
        T = se3.exp(xi) @ T
    return T
