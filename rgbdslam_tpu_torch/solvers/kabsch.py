"""Weighted rigid-transform fit by Horn's quaternion method, batched (port
of rgbdslam_tpu/solvers/kabsch.py; pcl::TransformationFromCorrespondences,
Solver/SolverSE3.cpp:161-179).

The optimal rotation is the dominant eigenvector of Horn's symmetric 4x4
matrix, found by 30 shifted power iterations — batched 4x4 products, no SVD.
"""

from __future__ import annotations

import functools

import torch

from rgbdslam_tpu_torch.geometry import se3


@functools.lru_cache()
def _power_start(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The power iteration's start vector on `device`, copied there once (a
    copy from host memory would make every fit wait for the device)."""
    q = torch.tensor([1.0, 0.03, 0.02, 0.01], dtype=dtype, device=device)
    return q / torch.linalg.norm(q)


def _horn_quaternion(S: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Dominant eigenvector (as quaternion (w,x,y,z)) of Horn's N matrix.
    S: (..., 3, 3) weighted cross-covariance sum_i w q1_i q2_i^T."""
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], dim=-1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], dim=-1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], dim=-1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], dim=-1),
        ],
        dim=-2,
    )
    # shift so the largest algebraic eigenvalue is also largest in magnitude
    # (Gershgorin row-sum bound)
    shift = torch.sum(torch.abs(N), dim=-1).amax(dim=-1)
    M = N + shift[..., None, None] * torch.eye(4, dtype=N.dtype, device=N.device)
    q = _power_start(N.dtype, N.device).expand(N.shape[:-2] + (4,))
    for _ in range(iters):
        q = (M @ q[..., None])[..., 0]
        q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-20)
    return q


def weighted_rigid_transform(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor,
                             iters: int = 30) -> torch.Tensor:
    """Fit T21 (..., 4, 4) with p2 ~= R p1 + t, weighted least squares.
    p1, p2: (..., N, 3); w: (..., N) nonnegative. A zero weight sum gives
    the identity."""
    wsum = torch.sum(w, dim=-1, keepdim=True)
    wn = w / torch.clamp_min(wsum, 1e-12)
    c1 = torch.sum(wn[..., None] * p1, dim=-2)
    c2 = torch.sum(wn[..., None] * p2, dim=-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    S = torch.einsum("...n,...ni,...nj->...ij", wn, q1, q2)
    quat_wxyz = _horn_quaternion(S, iters)
    q_xyzw = torch.cat([quat_wxyz[..., 1:], quat_wxyz[..., :1]], dim=-1)
    R = se3.rotation_from_quat(q_xyzw)
    t = c2 - (R @ c1[..., None])[..., 0]
    T = se3.from_Rt(R, t)
    degenerate = (wsum[..., 0] <= 1e-12)[..., None, None]
    return torch.where(degenerate, torch.eye(4, dtype=T.dtype, device=T.device), T)


def weighted_similarity_transform(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor,
                                  iters: int = 30) -> torch.Tensor:
    """Fit Sim(3) S21 (..., 4, 4) = [[s R, t], [0, 1]] with p2 ~= s R p1 + t,
    weighted least squares: the scale-aware Umeyama fit (the Eigen::umeyama
    of Solver/Ransac.cpp:210-245 with its scale free) for cross-session map
    merging. The rotation is Horn's, as in `weighted_rigid_transform`; the
    optimal scale under it is s = sum w q2.(R q1) / sum w |q1|^2, floored at
    1e-6. A zero weight sum gives the identity."""
    wsum = torch.sum(w, dim=-1, keepdim=True)
    wn = w / torch.clamp_min(wsum, 1e-12)
    c1 = torch.sum(wn[..., None] * p1, dim=-2)
    c2 = torch.sum(wn[..., None] * p2, dim=-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    S = torch.einsum("...n,...ni,...nj->...ij", wn, q1, q2)
    quat_wxyz = _horn_quaternion(S, iters)
    q_xyzw = torch.cat([quat_wxyz[..., 1:], quat_wxyz[..., :1]], dim=-1)
    R = se3.rotation_from_quat(q_xyzw)
    rq1 = R @ q1.transpose(-1, -2)                            # (..., 3, N)
    num = torch.einsum("...n,...in,...ni->...", wn, rq1, q2)
    den = torch.einsum("...n,...ni,...ni->...", wn, q1, q1)
    s = torch.clamp_min(num / torch.clamp_min(den, 1e-12), 1e-6)
    t = c2 - s[..., None] * (R @ c1[..., None])[..., 0]
    T = se3.from_Rt(s[..., None, None] * R, t)
    degenerate = (wsum[..., 0] <= 1e-12)[..., None, None]
    return torch.where(degenerate, torch.eye(4, dtype=T.dtype, device=T.device), T)
