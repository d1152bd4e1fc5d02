"""Sim(3): similarity transforms (scale + rotation + translation) on torch
tensors (port of rgbdslam_tpu/geometry/sim3.py).

RGB-D depth makes scale observable, so SE(3) is the live default; Sim(3)
serves cross-session map alignment (mapping/merge.py), where a session
recorded with the wrong depth factor is uniformly mis-scaled.

Representation: 4x4 matrix [[s*R, t], [0, 1]] with s > 0. Tangent vector
xi = [rho (3), phi (3), sigma (1)].

The translation part of exp and log uses the series
W = sum_n M^n / (n+1)!  with  M = sigma*I + hat(phi), which converges
rapidly for |sigma|, |phi| <= pi and is branch-free (no case analysis,
smooth under forward-mode autodiff). The 3x3 determinant and solve are
written out (cofactors, adjugate) where the JAX package calls its LU: no
library call, so nothing under `vmap` reads an error flag back to the
host.
"""

from __future__ import annotations

import torch

from rgbdslam_tpu_torch.geometry import se3

_W_TERMS = 12  # series terms: ||M|| <= pi + 1 -> term_12 / 13! ~ 1e-7


def _w_matrix(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W(phi, sigma) = sum_{n>=0} M^n/(n+1)!, M = sigma I + hat(phi), the
    terms added in the JAX package's order."""
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    M = sigma[..., None, None] * eye + se3.hat(phi)
    term = eye.expand(M.shape)
    out = term
    for n in range(1, _W_TERMS):
        term = (term @ M) / (n + 1.0)
        out = out + term
    return out


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Sim(3) exponential: (..., 7) [rho, phi, sigma] -> (..., 4, 4)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = se3.so3_exp(phi)
    t = (_w_matrix(phi, sigma) @ rho[..., None])[..., 0]
    return se3.from_Rt(s[..., None, None] * R, t)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors: elementwise, so it makes no
    library call and reads no error flag back to the host."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _solve3(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M^-1 b for (..., 3, 3) and (..., 3) by the adjugate (M is the
    well-conditioned W of `log`)."""
    c0 = torch.linalg.cross(M[..., 1, :], M[..., 2, :])
    c1 = torch.linalg.cross(M[..., 2, :], M[..., 0, :])
    c2 = torch.linalg.cross(M[..., 0, :], M[..., 1, :])
    det = torch.sum(M[..., 0, :] * c0, dim=-1)
    adj_b = c0 * b[..., 0:1] + c1 * b[..., 1:2] + c2 * b[..., 2:3]
    return adj_b / det[..., None]


def scale_of(S: torch.Tensor) -> torch.Tensor:
    """Scale factor of a Sim(3) matrix (det(sR) = s^3)."""
    return _det3(S[..., :3, :3]) ** (1.0 / 3.0)


def log(S: torch.Tensor) -> torch.Tensor:
    """Sim(3) log: (..., 4, 4) -> (..., 7). Smooth near the identity."""
    s = scale_of(S)
    R = S[..., :3, :3] / s[..., None, None]
    t = S[..., :3, 3]
    sigma = torch.log(s)
    phi = se3.so3_log_smooth(R)
    W = _w_matrix(phi, sigma)
    rho = _solve3(W, t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def inverse(S: torch.Tensor) -> torch.Tensor:
    """[[s R, t]]^-1 = [[R^T / s, -R^T t / s]]."""
    s = scale_of(S)
    R = S[..., :3, :3] / s[..., None, None]
    t = S[..., :3, 3]
    R_inv = (1.0 / s)[..., None, None] * R.transpose(-1, -2)
    return se3.from_Rt(R_inv, -(R_inv @ t[..., None])[..., 0])


def transform_points(S: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply s*R*p + t to points (..., N, 3)."""
    return pts @ S[..., :3, :3].transpose(-1, -2) + S[..., :3, 3][..., None, :]


def from_se3(T: torch.Tensor, scale=1.0) -> torch.Tensor:
    """The rigid pose T with its rotation block scaled by `scale`."""
    out = T.clone()
    out[..., :3, :3] *= scale
    return out
