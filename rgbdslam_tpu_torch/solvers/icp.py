"""Plane-to-plane GICP refinement over matched keypoints, and depth-patch
surface covariances (port of rgbdslam_tpu/solvers/icp.py, reassociate=False).

Warm-started from the RANSAC transform, `gicp_refine` refines T21 so that
R p1 + t ~= p2, keeping the descriptor pairing and gating each pair by
max_correspondence_dist per round (Solver/Gicp.cpp:37-66,
System/Tracking.cpp:148-149). On CUDA the whole of it (Gauss-Newton loop,
convergence gate, fallback) is one launch of kernel K4 (ops/kernels.py); on
the CPU it is the plain loop and `_finish_gicp`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rgbdslam_tpu_torch.config import IcpConfig
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.ops import image as image_ops
from rgbdslam_tpu_torch.ops import kernels


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

    C1, C2: (N, 3, 3) surface covariances (depth_patch_covariances).
    Returns (T21, converged bool, matched count int32); an under-constrained
    or non-finite result falls back to T_init (Solver/Gicp.cpp:23)."""
    if cfg.reassociate:
        raise NotImplementedError("reassociating GICP is not yet ported")
    if C1 is None or C2 is None:
        raise NotImplementedError("kNN covariances are not yet ported: pass C1 and C2")
    if kernels.on_cuda(T_init, p1, p2, C1, C2, valid):
        return kernels.gicp_refine_fused(
            T_init, p1, p2, C1, C2, valid, cfg.max_iterations,
            cfg.max_correspondence_dist, cfg.min_matches)[0]
    T_fin, _cost, _cnt = kernels.gicp_refine_ref(
        T_init, p1, p2, C1, C2, valid, cfg.max_iterations,
        cfg.max_correspondence_dist)
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
    `kernels.gicp_refine_fused` does after its loop."""
    n_valid = torch.sum(valid)
    enough = n_valid >= cfg.min_matches
    q = p1 @ T_fin[:3, :3].T + T_fin[:3, 3]
    gated = valid & (torch.linalg.norm(q - p2, dim=-1) < cfg.max_correspondence_dist)
    converged = enough & (torch.sum(gated) >= cfg.min_matches)
    converged = converged & torch.isfinite(T_fin).all()
    T_out = torch.where(converged, T_fin, T_init)
    return T_out, converged, n_valid.to(torch.int32)
