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
from rgbdslam_tpu_torch.mesh import Mesh
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


def block_diagonal(Haa, Hbb, edges: PoseGraphEdges, K: int) -> torch.Tensor:
    """The 6x6 diagonal blocks (K, 6, 6) of the edges' H (over a shard of
    the edges, that shard's share)."""
    D = torch.zeros((K, 6, 6), dtype=Haa.dtype, device=Haa.device)
    D.index_put_((edges.a,), Haa, accumulate=True)
    D.index_put_((edges.b,), Hbb, accumulate=True)
    return D


def gradient(ga, gb, edges: PoseGraphEdges, K: int) -> torch.Tensor:
    """The rhs g (K, 6) of the edges (over a shard, its share)."""
    g = torch.zeros((K, 6), dtype=ga.dtype, device=ga.device)
    g.index_put_((edges.a,), ga, accumulate=True)
    g.index_put_((edges.b,), gb, accumulate=True)
    return g


def edge_matvec(x, Haa, Hbb, Hab, edges: PoseGraphEdges) -> torch.Tensor:
    """The edges' H applied to x (K, 6), without damping or gauge prior:
    one scatter over the edges (over a shard, its share)."""
    a_idx, b_idx = edges.a, edges.b
    xa, xb = x[a_idx], x[b_idx]
    ya = torch.einsum("eij,ej->ei", Haa, xa) + torch.einsum("eij,ej->ei", Hab, xb)
    yb = torch.einsum("eij,ej->ei", Hbb, xb) + torch.einsum("eji,ej->ei", Hab, xa)
    y = torch.zeros_like(x)
    y.index_put_((a_idx,), ya, accumulate=True)
    y.index_put_((b_idx,), yb, accumulate=True)
    return y


def _cg_lm(Twc, shards, fixed, mesh: Mesh, iterations: int, cg_iters: int,
           huber_delta: float, lm_lambda0: float, adaptive: bool):
    """The CG LM over the edge shards of `mesh` (one PoseGraphEdges a local
    shard; the plain solve: the whole edge set on Mesh([device])). Each
    shard holds its edges' 6x6 blocks and the replicated O(K) vectors. Per
    GN iteration the reductions are one (K, 6, 6) psum (the block-Jacobi
    preconditioner), one (K, 6) psum (the gradient, with the cost riding
    along) and one scalar psum (the candidate's cost); per CG iteration
    exactly one (K, 6) psum (the matvec). The solve and the state live on
    the mesh's home device."""
    K = Twc.shape[0]
    fixed = fixed.to(mesh.home)
    dtype = Twc.dtype
    fixed_f = fixed[:, None].to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=mesh.home)
    Twc_cur, lam, cost = _lm_state(Twc.to(mesh.home), lm_lambda0)
    for _ in range(iterations):
        blocks = [edge_blocks(x, ed, huber_delta)
                  for x, ed in zip(mesh.replicate(Twc_cur), shards)]

        # block diagonal of H (+ damping, + the gauge prior) for the Jacobi
        # preconditioner
        D = mesh.psum([block_diagonal(bl[0], bl[1], ed, K) for bl, ed in zip(blocks, shards)])
        D = D + lam * eye6 + (fixed_f[..., None] * 1e9) * eye6
        D_inv = torch.linalg.inv_ex(D)[0]
        g, cost_it = mesh.psum([(gradient(bl[3], bl[4], ed, K), bl[5])
                                for bl, ed in zip(blocks, shards)])

        def H_mv(x, blocks=blocks, lam=lam):
            y = mesh.psum([edge_matvec(xs, bl[0], bl[1], bl[2], ed)
                           for xs, bl, ed in zip(mesh.replicate(x), blocks, shards)])
            return y + lam * x + (fixed_f * 1e9) * x

        def M_inv(x, D_inv=D_inv):
            return torch.einsum("kij,kj->ki", D_inv, x)

        xi = pcg(H_mv, M_inv, -g, cg_iters)
        xi = torch.where(fixed[:, None], 0.0, xi)
        Twc_cand = se3.exp(xi) @ Twc_cur
        if not adaptive:
            Twc_cur, cost = Twc_cand, cost_it
            continue
        cost_new = mesh.psum([graph_cost(x, ed, huber_delta)
                              for x, ed in zip(mesh.replicate(Twc_cand), shards)])
        Twc_cur, lam, cost = _lm_update(cost_new < cost_it, lam, cost_it, cost_new,
                                        Twc_cur, Twc_cand)
    return Twc_cur, cost


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
    return _cg_lm(Twc, (edges,), fixed, Mesh([Twc.device]), iterations, cg_iters,
                  huber_delta, lm_lambda0, adaptive)
