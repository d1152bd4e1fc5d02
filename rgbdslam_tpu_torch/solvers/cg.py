"""Matrix-free block CG for large pose graphs (port of
rgbdslam_tpu/solvers/cg.py).

The dense solve is O((6K)^3) and materialises H; for large K the
Gauss-Newton step instead solves H xi = -g by conjugate gradients with H
applied implicitly from the per-edge blocks:

    (H x)_a = sum_{e: a(e)=a} [Haa_e x_a + Hab_e x_b] + ...

one scatter per CG iteration, O(E * 36) operations, no K^2 memory. A
block-Jacobi preconditioner (inverse of the 6x6 diagonal blocks) keeps the
iteration count low.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.solvers.pose_graph import (
    PoseGraphEdges,
    _lm_state,
    _lm_update,
    edge_blocks,
    graph_cost,
)


def pcg(H_mv, M_inv, b_rhs: torch.Tensor, iters: int) -> torch.Tensor:
    """Preconditioned conjugate gradients on H x = b with a fixed iteration
    count (no convergence test, so nothing is read back to the host).
    H_mv / M_inv: matvec and preconditioner, (K, 6) -> (K, 6)."""
    x = torch.zeros_like(b_rhs)
    r = b_rhs
    p = M_inv(b_rhs)
    rz = torch.sum(r * p)
    for _ in range(iters):
        Hp = H_mv(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Hp), 1e-20)
        x = x + alpha * p
        r = r - alpha * Hp
        z = M_inv(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / torch.clamp_min(rz, 1e-20)) * p
        rz = rz_new
    return x


def optimize_pose_graph_cg(
    Twc: torch.Tensor,
    edges: PoseGraphEdges,
    fixed: torch.Tensor,
    iterations: int = 10,
    cg_iters: int = 50,
    huber_delta: float = 1.0,
    lm_lambda0: float = 1e-4,
    adaptive: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt with an inner matrix-free preconditioned CG
    solve. Same problem and convention as optimize_pose_graph, which it
    matches to CG tolerance; memory O(K + E) instead of O(K^2)."""
    K = Twc.shape[0]
    dtype, dev = Twc.dtype, Twc.device
    a_idx, b_idx = edges.a, edges.b
    fixed_f = fixed[:, None].to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    Twc_cur, lam, cost = _lm_state(Twc, lm_lambda0)
    for _ in range(iterations):
        Haa, Hbb, Hab, ga, gb, cost_it = edge_blocks(Twc_cur, edges, huber_delta)

        # block diagonal of H (+ damping, + the gauge prior) for the Jacobi
        # preconditioner
        D = torch.zeros((K, 6, 6), dtype=dtype, device=dev)
        D.index_put_((a_idx,), Haa, accumulate=True)
        D.index_put_((b_idx,), Hbb, accumulate=True)
        D = D + lam * eye6 + (fixed_f[..., None] * 1e9) * eye6
        D_inv = torch.linalg.inv_ex(D)[0]

        g = torch.zeros((K, 6), dtype=dtype, device=dev)
        g.index_put_((a_idx,), ga, accumulate=True)
        g.index_put_((b_idx,), gb, accumulate=True)

        def H_mv(x, Haa=Haa, Hbb=Hbb, Hab=Hab, lam=lam):
            xa, xb = x[a_idx], x[b_idx]
            ya = torch.einsum("eij,ej->ei", Haa, xa) + torch.einsum("eij,ej->ei", Hab, xb)
            yb = torch.einsum("eij,ej->ei", Hbb, xb) + torch.einsum("eji,ej->ei", Hab, xa)
            y = torch.zeros_like(x)
            y.index_put_((a_idx,), ya, accumulate=True)
            y.index_put_((b_idx,), yb, accumulate=True)
            return y + lam * x + (fixed_f * 1e9) * x

        def M_inv(x, D_inv=D_inv):
            return torch.einsum("kij,kj->ki", D_inv, x)

        xi = pcg(H_mv, M_inv, -g, cg_iters)
        xi = torch.where(fixed[:, None], 0.0, xi)
        Twc_cand = se3.exp(xi) @ Twc_cur
        if not adaptive:
            Twc_cur, cost = Twc_cand, cost_it
            continue
        cost_new = graph_cost(Twc_cand, edges, huber_delta)
        Twc_cur, lam, cost = _lm_update(cost_new < cost_it, lam, cost_it, cost_new,
                                        Twc_cur, Twc_cand)
    return Twc_cur, cost
