"""SE(3) / SO(3) / quaternion math on torch tensors (port of
rgbdslam_tpu/geometry/se3.py).

float32 homogeneous 4x4 matrices with the reference's `Tcw` (world->camera)
convention; leading batch dimensions broadcast. Tangent-space convention:
xi = [rho, phi] (translation part first), T = exp(hat(xi)).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rgbdslam_tpu_torch.device import resolve_device

_EPS = 1e-8


@functools.lru_cache()
def _bottom_row(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[0, 0, 0, 1] on `device`, copied there once: a copy from host memory
    makes the host wait for the device, which the per-frame path must not."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).reshape(phi.shape[:-1] + (3, 3))


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula with small-angle Taylor fallback. (...,3)->(...,3,3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(phi)
    WW = W @ W
    return _eye3(phi) + a[..., None, None] * W + b[..., None, None] * WW


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(phi)
    WW = W @ W
    return _eye3(phi) + b[..., None, None] * W + c[..., None, None] * WW


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map: (..., 6) [rho, phi] -> (..., 4, 4). The
    arithmetic of so3_exp and of the left Jacobian, each shared term
    computed once (a solver loop calls this every round)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    sin = torch.sin(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - sin) / (theta2 * theta))
    W = hat(phi)
    WW = W @ W
    eye = _eye3(phi)
    R = eye + a[..., None, None] * W + b[..., None, None] * WW
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    return from_Rt(R, (V @ rho[..., None])[..., 0])


def from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (...,3,3) and translation (...,3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = _bottom_row(R.dtype, R.device).expand(batch + (4,))[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def identity(dtype: torch.dtype = torch.float32, device="cuda") -> torch.Tensor:
    """The 4x4 identity pose on `device` (the card unless the caller asks
    for the CPU)."""
    return torch.eye(4, dtype=dtype, device=resolve_device(device))


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint of SE(3): (..., 4, 4) -> (..., 6, 6), acting on [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    top = torch.cat([R, hat(t) @ R], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Rigid-transform inverse [R^T | -R^T t] (no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return from_Rt(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def translation_norm(T: torch.Tensor) -> torch.Tensor:
    """|t|, the reference's `tnorm` (System/Tracking.cpp:201-205)."""
    return torch.linalg.norm(T[..., :3, 3], dim=-1)


def rotation_angle(T: torch.Tensor) -> torch.Tensor:
    """acos((tr(R) - 1) / 2), the reference's `rnorm`
    (System/Tracking.cpp:207-211)."""
    tr = T[..., 0, 0] + T[..., 1, 1] + T[..., 2, 2]
    return torch.arccos(torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0))


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3): (..., 3, 3) -> (..., 3), for angles up to pi.

    The generic branch normalises by |w| = 2 sin(theta) from the skew part;
    near pi the axis comes from the column of R + I with the largest
    diagonal entry, signed to agree with w."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = vee(R - R.transpose(-1, -2))
    w_norm = torch.linalg.norm(w, dim=-1)
    theta = torch.atan2(w_norm, trace - 1.0)
    small = w_norm < 1e-6
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / torch.where(small, 1.0, w_norm))
    generic = w * scale[..., None]
    B = R + _eye3(R)
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    largest = torch.argmax(diag, dim=-1)
    col = torch.take_along_dim(
        B, largest[..., None, None].expand(B.shape[:-1] + (1,)), dim=-1)[..., :, 0]
    axis = col / torch.clamp_min(torch.linalg.norm(col, dim=-1, keepdim=True), 1e-12)
    w_dot = torch.sum(axis * w, dim=-1, keepdim=True)
    axis = torch.where(w_dot < 0, -axis, axis)
    near_pi = theta > (np.pi - 3e-4)
    return torch.where(near_pi[..., None], axis * theta[..., None], generic)


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    half = 0.5 * theta
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp_min(torch.sin(half), 1e-20))
        / torch.clamp_min(theta2, _EPS * _EPS))
    W = hat(phi)
    return _eye3(phi) - 0.5 * W + cot[..., None, None] * (W @ W)


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log map: (..., 4, 4) -> (..., 6) [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    rho = (_so3_left_jacobian_inv(phi) @ T[..., :3, 3, None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def so3_log_smooth(R: torch.Tensor) -> torch.Tensor:
    """atan2-based SO(3) log, smooth at the identity (valid for theta < pi):
    the form Gauss-Newton residuals and their derivatives use."""
    w = vee(R - R.transpose(-1, -2))
    s = torch.sqrt(torch.sum(w * w, dim=-1) + 1e-20)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.atan2(s, tr - 1.0)
    small = s < 1e-6
    s_safe = torch.where(small, 1.0, s)
    factor = torch.where(small, 0.5 + theta * theta / 12.0, theta / s_safe)
    return w * factor[..., None]


def log_smooth(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log with smooth derivatives near the identity: (..., 4, 4) ->
    (..., 6) [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log_smooth(R)
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    half = 0.5 * torch.sqrt(theta2_safe)
    sin_half = torch.sin(half)
    sin_half_safe = torch.where(torch.abs(sin_half) < 1e-8, 1e-8, sin_half)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - half * torch.cos(half) / sin_half_safe) / theta2_safe)
    W = hat(phi)
    Jinv = _eye3(T) - 0.5 * W + coef[..., None, None] * (W @ W)
    rho = (Jinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def inverse_np(T):
    """Host-numpy closed-form inverse of (..., 4, 4) pose stacks:
    [R^T | -R^T t] (the same form the device uses)."""
    T = np.asarray(T)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = np.swapaxes(R, -1, -2)
    out = np.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


def orthonormalize_np(T):
    """Project the rotation block of (..., 4, 4) host poses back onto SO(3)
    (polar projection via SVD, det-corrected), keeping the translation.
    Returns float32.

    Chained f32 composes drift the rotation's scale by ~1e-7 per product,
    and the closed-form `inverse_np` mirrors that scale error instead of
    inverting it; re-anchoring poses through it then feeds the error back
    with the wrong sign (see the JAX package's twin for the measured
    blow-up). Project every pose that is composed on the host and later
    inverted in closed form."""
    T = np.asarray(T)
    R = T[..., :3, :3].astype(np.float64)
    U, _, Vt = np.linalg.svd(R)
    d = np.sign(np.linalg.det(U @ Vt))
    U = U.copy()
    U[..., :, 2] *= np.asarray(d)[..., None]
    out = T.astype(np.float32).copy()
    out[..., :3, :3] = (U @ Vt).astype(np.float32)
    return out


def quat_from_rotation(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> unit quaternion (...,4) as (x,y,z,w).

    Branch-free Shepperd's method: all four candidate forms, the numerically
    best picked by the largest diagonal combination."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    qw2 = torch.clamp_min(1.0 + tr, 0.0)
    qx2 = torch.clamp_min(1.0 + m00 - m11 - m22, 0.0)
    qy2 = torch.clamp_min(1.0 - m00 + m11 - m22, 0.0)
    qz2 = torch.clamp_min(1.0 - m00 - m11 + m22, 0.0)

    sw = torch.sqrt(qw2 + 1e-20)
    qa = torch.stack([m21 - m12, m02 - m20, m10 - m01, sw * sw], -1) / (2.0 * sw[..., None])
    sx = torch.sqrt(qx2 + 1e-20)
    qb = torch.stack([sx * sx, m01 + m10, m02 + m20, m21 - m12], -1) / (2.0 * sx[..., None])
    sy = torch.sqrt(qy2 + 1e-20)
    qc = torch.stack([m01 + m10, sy * sy, m12 + m21, m02 - m20], -1) / (2.0 * sy[..., None])
    sz = torch.sqrt(qz2 + 1e-20)
    qd = torch.stack([m02 + m20, m12 + m21, sz * sz, m10 - m01], -1) / (2.0 * sz[..., None])

    choice = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), dim=-1)[..., None]
    q = torch.where(choice == 0, qa,
                    torch.where(choice == 1, qb, torch.where(choice == 2, qc, qd)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rotation_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (...,4) (x,y,z,w) -> rotation matrix (...,3,3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )
