"""Plain SE(3) arithmetic on torch tensors of any float type: the hat map,
the exponential, the closed-form inverse and the log that is smooth at the
identity. Tangent vectors are [rho, phi], translation first; leading batch
dimensions broadcast."""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-8


def hat(phi: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).reshape(phi.shape[:-1] + (3, 3))


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    bottom = torch.cat([torch.zeros_like(t), torch.ones_like(t[..., :1])], dim=-1)
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom[..., None, :]], dim=-2)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 4, 4): Rodrigues' rotation and the left Jacobian
    on the translation, with their small-angle series."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, EPS * EPS))
    small = theta2 < EPS
    sin = torch.sin(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - sin) / (theta2 * theta))
    W = hat(phi)
    WW = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[..., None, None] * W + b[..., None, None] * WW
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    return from_rt(R, (V @ rho[..., None])[..., 0])


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return from_rt(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


def log_smooth(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6), by atan2: smooth derivatives near the
    identity, valid below an angle of pi."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s = torch.sqrt(torch.sum(w * w, dim=-1) + 1e-20)
    theta = torch.atan2(s, R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    small_s = s < 1e-6
    phi = w * torch.where(small_s, 0.5 + theta * theta / 12.0,
                          theta / torch.where(small_s, 1.0, s))[..., None]
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    half = 0.5 * torch.sqrt(theta2_safe)
    sin_half = torch.sin(half)
    sin_half = torch.where(torch.abs(sin_half) < 1e-8, 1e-8, sin_half)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - half * torch.cos(half) / sin_half) / theta2_safe)
    W = hat(phi)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Jinv = eye - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([(Jinv @ t[..., None])[..., 0], phi], dim=-1)


def relative_error(T_est: np.ndarray, T_ref: np.ndarray) -> tuple:
    """(translation m, rotation rad) of inv(T_ref) T_est, float64, for
    (..., 4, 4) host stacks."""
    T_est, T_ref = np.asarray(T_est, np.float64), np.asarray(T_ref, np.float64)
    Rt = np.swapaxes(T_ref[..., :3, :3], -1, -2)
    R = Rt @ T_est[..., :3, :3]
    t = np.einsum("...ij,...j->...i", Rt, T_est[..., :3, 3] - T_ref[..., :3, 3])
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    return np.linalg.norm(t, axis=-1), np.arctan2(0.5 * np.linalg.norm(w, axis=-1),
                                                  0.5 * (tr - 1.0))
