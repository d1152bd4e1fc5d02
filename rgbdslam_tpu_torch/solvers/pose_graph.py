"""SE(3) and Sim(3) pose-graph optimization: batched Levenberg-Marquardt with
a dense solve, and the host-side graph registry (port of
rgbdslam_tpu/solvers/pose_graph.py; the g2o backend of
Solver/PoseGraph.cpp:30-57, 186-243). The Sim(3) graph (7-dof blocks, the
same loop) serves the cross-session map merge (mapping/merge.py).

The graph is arrays: vertex poses Twc (K, 4, 4) and edges (a (E,), b (E,),
Z (E, 4, 4), weight (E,)) with the measurement convention Z = T_{a<-b}
(g2o setMeasurementFromState: Z = X_a^-1 X_b). Per iteration:

1. per-edge residual r = log(Z^-1 Twc_a^-1 Twc_b) and its Jacobians with
   respect to left-multiplied increments of both endpoints, by forward-mode
   autodiff batched over the edges (torch.func.jacfwd under vmap);
2. Huber IRLS reweighting;
3. scatter-add of the 6x6 blocks into the dense H (6K, 6K) and the rhs
   (`index_put_` with accumulate: on a card the order of the float adds is
   not fixed, so results are reproducible to rounding, not to the bit);
4. gauge fixing by a strong prior on the fixed vertices
   (Solver/PoseGraph.cpp:354-360 fixes vertex 0);
5. a damped dense solve (`torch.linalg.solve_ex`, a library call as in the
   JAX package), with masked step accept/reject: no host branch and no
   host synchronisation inside the loop.

Unlike the JAX package the arrays are not padded to power-of-two budgets:
there is no compiled program to reuse, and a pinned padding vertex or a
zero-weight edge contributes nothing to the solve.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from rgbdslam_tpu_torch.device import resolve_device, upload
from rgbdslam_tpu_torch.geometry import se3, sim3
from rgbdslam_tpu_torch.mesh import Mesh


class PoseGraphEdges(NamedTuple):
    a: torch.Tensor        # (E,) int64 vertex index (the edge's "current" side)
    b: torch.Tensor        # (E,) int64 vertex index (the edge's "other" side)
    Z: torch.Tensor        # (E, 4, 4) measurement T_{a<-b}
    weight: torch.Tensor   # (E,) f32 information scale (0 = invalid slot)


def edge_residual(Ta: torch.Tensor, Tb: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """r = log(Z^-1 Ta^-1 Tb), the g2o EdgeSE3 error convention, with the
    log that is smooth near the identity (where residuals live)."""
    return se3.log_smooth(se3.inverse(Z) @ se3.inverse(Ta) @ Tb)


def _residual_and_jacobians(Ta, Tb, Z):
    """Residual (6,) and Jacobians (6, 6) x 2 with respect to left
    increments of Ta and Tb, for one edge."""

    def f(xi_ab):
        # a leading dimension of one keeps the scalars of exp and log
        # one-dimensional: under vmap a zero-dimensional tensor promotes
        # with Python floats to float64
        E = se3.exp(xi_ab.reshape(2, 6))
        return edge_residual((E[0] @ Ta)[None], (E[1] @ Tb)[None], Z[None])[0]

    zero = torch.zeros((12,), dtype=Ta.dtype, device=Ta.device)
    J, r = torch.func.jacfwd(lambda x: (f(x),) * 2, has_aux=True)(zero)  # (6, 12)
    return r, J[:, :6], J[:, 6:]


def residuals_and_jacobians(Ta, Tb, Z):
    """Batched over edges: r (E, 6), Ja (E, 6, 6), Jb (E, 6, 6)."""
    return torch.func.vmap(_residual_and_jacobians)(Ta, Tb, Z)


def _huber_weight(r_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel (g2o RobustKernelHuber)."""
    return torch.where(r_norm <= delta, 1.0, delta / torch.clamp_min(r_norm, 1e-12))


def _huber_cost(r_norm: torch.Tensor, weight: torch.Tensor, delta: float) -> torch.Tensor:
    """The robust objective sum_e w_e rho_delta(|r_e|) that Levenberg's
    accept/reject compares."""
    quad = r_norm * r_norm
    lin = 2.0 * delta * r_norm - delta * delta
    return torch.sum(weight * torch.where(r_norm <= delta, quad, lin))


def graph_cost(Twc: torch.Tensor, edges: PoseGraphEdges, huber_delta: float) -> torch.Tensor:
    """Robust pose-graph objective at `Twc` (residual-only pass)."""
    r = edge_residual(Twc[edges.a], Twc[edges.b], edges.Z)
    return _huber_cost(torch.linalg.norm(r, dim=-1), edges.weight, huber_delta)


# LM lambda schedule: x2 on a rejected step, /3 on an accepted one, the
# fixed-trip, masked-accept analog of g2o Levenberg's adaptive lambda.
LM_REJECT_FACTOR = 2.0
LM_ACCEPT_FACTOR = 1.0 / 3.0
LM_LAMBDA_MIN = 1e-9
LM_LAMBDA_MAX = 1e8


def _lm_update(accept, lam, cost, cost_new, x_cur, x_cand):
    """Masked LM accept/reject shared by both solvers: returns (x_next,
    lam_next, cost_next), all on the device."""
    lam_next = torch.clamp(
        torch.where(accept, lam * LM_ACCEPT_FACTOR, lam * LM_REJECT_FACTOR),
        LM_LAMBDA_MIN, LM_LAMBDA_MAX)
    return (torch.where(accept, x_cand, x_cur), lam_next,
            torch.where(accept, cost_new, cost))


def _weighted_blocks(r, Ja, Jb, weight, huber_delta: float):
    """Huber-reweighted Gauss-Newton blocks of per-edge residuals and
    Jacobians: Haa, Hbb, Hab (E, D, D); ga, gb (E, D); the robust cost."""
    r_norm = torch.linalg.norm(r, dim=-1)
    w = weight * _huber_weight(r_norm, huber_delta)
    cost = _huber_cost(r_norm, weight, huber_delta)
    Haa = torch.einsum("eij,eik,e->ejk", Ja, Ja, w)
    Hbb = torch.einsum("eij,eik,e->ejk", Jb, Jb, w)
    Hab = torch.einsum("eij,eik,e->ejk", Ja, Jb, w)
    ga = torch.einsum("eij,ei,e->ej", Ja, r, w)
    gb = torch.einsum("eij,ei,e->ej", Jb, r, w)
    return Haa, Hbb, Hab, ga, gb, cost


def edge_blocks(Twc, edges: PoseGraphEdges, huber_delta: float):
    """Per-edge Gauss-Newton blocks: Haa, Hbb, Hab (E, 6, 6); ga, gb (E, 6);
    the robust cost."""
    r, Ja, Jb = residuals_and_jacobians(Twc[edges.a], Twc[edges.b], edges.Z)
    return _weighted_blocks(r, Ja, Jb, edges.weight, huber_delta)


def _lm_state(Twc, lm_lambda0: float):
    return (Twc, torch.full((), lm_lambda0, dtype=Twc.dtype, device=Twc.device),
            torch.full((), float("inf"), dtype=Twc.dtype, device=Twc.device))


def _normal_equations(X, edges: PoseGraphEdges, huber_delta: float, K: int, D: int, blocks):
    """The edges' Gauss-Newton system: their blocks (`blocks`) scattered
    into the dense H (D K, D K) and the rhs g (D K,), and the robust cost.
    Over a shard of the edges it is that shard's share of the sums."""
    dtype, dev = X.dtype, X.device
    a, b = edges.a, edges.b
    Haa, Hbb, Hab, ga, gb, cost = blocks(X, edges, huber_delta)
    Hb = torch.zeros((K, K, D, D), dtype=dtype, device=dev)
    Hb.index_put_((a, a), Haa, accumulate=True)
    Hb.index_put_((b, b), Hbb, accumulate=True)
    Hb.index_put_((a, b), Hab, accumulate=True)
    Hb.index_put_((b, a), Hab.transpose(-1, -2), accumulate=True)
    g = torch.zeros((K, D), dtype=dtype, device=dev)
    g.index_put_((a,), ga, accumulate=True)
    g.index_put_((b,), gb, accumulate=True)
    return Hb.permute(0, 2, 1, 3).reshape(K * D, K * D), g.reshape(K * D), cost


def _damped_step(Hm, gv, lam, fixed, D: int):
    """The gauge prior and Marquardt damping (lam scales the diagonal), one
    damped solve: the increment xi (K, D), 0 on the fixed vertices."""
    K = fixed.shape[0]
    fixed_d = fixed[:, None].expand(K, D).reshape(K * D)
    diag_boost = torch.where(fixed_d, 1e9, lam + 1e-8)
    Hm = Hm + torch.diag(diag_boost) + lam * torch.diag(torch.diagonal(Hm))
    xi = -torch.linalg.solve_ex(Hm, gv[:, None])[0][:, 0].reshape(K, D)
    return torch.where(fixed[:, None], 0.0, xi)


def _dense_lm(X, shards, fixed, mesh: Mesh, iterations: int, huber_delta: float,
              lm_lambda0: float, adaptive: bool, D: int, blocks, exp, cost_of):
    """The dense LM shared by the SE(3) (D = 6) and Sim(3) (D = 7) graphs
    and by the edge-sharded solve (parallel/dist_ba.py): per iteration each
    edge shard's blocks (`blocks`) scattered into its dense (D K)^2 system,
    H, g and the cost summed over the mesh in one reduction, the gauge
    prior and Marquardt damping, one damped solve on the mesh's home
    device, the left update by `exp` and the masked accept/reject on the
    shards' summed `cost_of`. `shards`: one PoseGraphEdges a local shard of
    `mesh` (the plain solve: the whole edge set on Mesh([device])). No host
    branch and no host read inside the loop."""
    K = X.shape[0]
    fixed = fixed.to(mesh.home)
    X_cur, lam, cost = _lm_state(X.to(mesh.home), lm_lambda0)
    for _ in range(iterations):
        Hm, gv, cost_it = mesh.psum([_normal_equations(x, ed, huber_delta, K, D, blocks)
                                     for x, ed in zip(mesh.replicate(X_cur), shards)])
        xi = _damped_step(Hm, gv, lam, fixed, D)
        X_cand = exp(xi) @ X_cur
        if not adaptive:
            X_cur, cost = X_cand, cost_it
            continue
        cost_new = mesh.psum([cost_of(x, ed, huber_delta)
                              for x, ed in zip(mesh.replicate(X_cand), shards)])
        X_cur, lam, cost = _lm_update(cost_new < cost_it, lam, cost_it, cost_new,
                                      X_cur, X_cand)
    return X_cur, cost


def optimize_pose_graph(
    Twc: torch.Tensor,
    edges: PoseGraphEdges,
    fixed: torch.Tensor,
    iterations: int = 10,
    huber_delta: float = 1.0,
    lm_lambda0: float = 1e-4,
    adaptive: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimize vertex poses. Returns (Twc_opt (K, 4, 4), final cost ()).

    Twc: (K, 4, 4) vertex estimates (camera-to-world, like g2o VertexSE3
      seeded with the pose inverse, Solver/PoseGraph.cpp:190).
    edges: edge arrays; slots with weight 0 are ignored.
    fixed: (K,) bool; gauge-fixed vertices get a 1e9 prior on their
      increment (vertex 0, Solver/PoseGraph.cpp:191, 358).
    adaptive: True = Levenberg-Marquardt with step accept/reject and the
      x2 / /3 lambda schedule from lm_lambda0; False = fixed-damping
      Gauss-Newton."""
    return _dense_lm(Twc, (edges,), fixed, Mesh([Twc.device]), iterations, huber_delta,
                     lm_lambda0, adaptive, 6, edge_blocks, se3.exp, graph_cost)


# ---------------------------------------------------------------------------
# Sim(3) graph: scale-drift-aware optimization (JAX pose_graph.py:198-290).
# RGB-D runs use SE(3), since depth pins the scale; the cross-session map
# merge (mapping/merge.py) uses this.
# ---------------------------------------------------------------------------


def sim3_edge_residual(Sa: torch.Tensor, Sb: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """r = log_sim3(Z^-1 Sa^-1 Sb) in R^7."""
    return sim3.log(sim3.inverse(Z) @ sim3.inverse(Sa) @ Sb)


def _sim3_residual_and_jacobians(Sa, Sb, Z):
    """Residual (7,) and Jacobians (7, 7) x 2 with respect to left Sim(3)
    increments of Sa and Sb, for one edge."""

    def f(xi_ab):
        # a leading dimension of one, as in `_residual_and_jacobians`
        E = sim3.exp(xi_ab.reshape(2, 7))
        return sim3_edge_residual((E[0] @ Sa)[None], (E[1] @ Sb)[None], Z[None])[0]

    zero = torch.zeros((14,), dtype=Sa.dtype, device=Sa.device)
    J, r = torch.func.jacfwd(lambda x: (f(x),) * 2, has_aux=True)(zero)  # (7, 14)
    return r, J[:, :7], J[:, 7:]


def sim3_edge_blocks(Swc, edges: PoseGraphEdges, huber_delta: float):
    """Per-edge blocks of the Sim(3) graph: Haa, Hbb, Hab (E, 7, 7); ga, gb
    (E, 7); the robust cost."""
    r, Ja, Jb = torch.func.vmap(_sim3_residual_and_jacobians)(
        Swc[edges.a], Swc[edges.b], edges.Z)
    return _weighted_blocks(r, Ja, Jb, edges.weight, huber_delta)


def sim3_graph_cost(Swc: torch.Tensor, edges: PoseGraphEdges,
                    huber_delta: float) -> torch.Tensor:
    """Robust Sim(3) graph objective at `Swc` (residual-only pass)."""
    r = sim3_edge_residual(Swc[edges.a], Swc[edges.b], edges.Z)
    return _huber_cost(torch.linalg.norm(r, dim=-1), edges.weight, huber_delta)


def optimize_sim3_graph(
    Swc: torch.Tensor,
    edges: PoseGraphEdges,
    fixed: torch.Tensor,
    iterations: int = 10,
    huber_delta: float = 1.0,
    lm_lambda0: float = 1e-4,
    adaptive: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt over Sim(3) vertices Swc (K, 4, 4) with Sim(3)
    measurements Z = S_{a<-b}: `optimize_pose_graph` with 7-dof blocks.
    Returns (Swc_opt (K, 4, 4), final cost ()).

    A merged map's graph has soft modes, the bending of a session's open
    chain (on a 160x120 tour merge the free Hessian's three smallest
    eigenvalues are 0.005 against 15,000 at the top): along them the f32
    solution moves by up to ~2e-3 with the order of the scatter-adds (the
    edges in another order, another device) at the same cost, in either
    package."""
    return _dense_lm(Swc, (edges,), fixed, Mesh([Swc.device]), iterations, huber_delta,
                     lm_lambda0, adaptive, 7, sim3_edge_blocks, sim3.exp, sim3_graph_cost)


# ---------------------------------------------------------------------------
# Host-side graph container (edge registry semantics of Solver/PoseGraph.cpp)
# ---------------------------------------------------------------------------


class PoseGraph:
    """Host registry of vertices and edges + the device optimization call.

    Mirrors PoseGraph's graph bookkeeping: odometry edge to the previous KF
    (createEdgeWithReference), measured proximity/loop edges (createEdge),
    (a, b)-keyed dedup (existEdge, Solver/PoseGraph.cpp:370-381).
    """

    def __init__(self, max_vertices: int, max_edges: int,
                 information: float = 100.0, huber_delta: float = 1.0,
                 cg_threshold: int = 256, cg_iters: int = 64,
                 lm_lambda0: float = 1e-4, device="cuda"):
        self.max_vertices = max_vertices
        self.max_edges = max_edges
        self.information = information
        self.huber_delta = huber_delta
        self.lm_lambda0 = lm_lambda0    # Levenberg start (PoseGraphConfig)
        self.device = resolve_device(device)
        # when set (SlamSystem with SlamConfig.distributed and more than one
        # device), every solve rides the mesh: the edge-sharded LM with the
        # matrix-free CG inner solve (parallel/dist_ba.py)
        self.mesh = None
        self.dist_solves = 0     # solves that rode the mesh
        # the multi-process publisher hooks (parallel/mp_slam.py): the
        # tracking process announces every vertex, edge and solve over the
        # constraint channel, so that backend peers hold the same graph and
        # join each solve's collectives
        self.on_vertex = None    # callback(k, Twc (4, 4))
        self.on_edge = None      # callback(a, b, Z, raw_weight, kind)
        self.on_solve = None     # callback(iterations, n_vertices, n_edges)
        # the padded vertex count at which the dense (6K)^2 solve gives way
        # to the matrix-free CG solve (solvers/cg.py)
        self.cg_threshold = cg_threshold
        self.cg_iters = cg_iters
        self.Twc = np.tile(np.eye(4, dtype=np.float32), (max_vertices, 1, 1))
        self.n_vertices = 0
        self.e_a = np.zeros((max_edges,), dtype=np.int32)
        self.e_b = np.zeros((max_edges,), dtype=np.int32)
        self.e_Z = np.tile(np.eye(4, dtype=np.float32), (max_edges, 1, 1))
        self.e_w = np.zeros((max_edges,), dtype=np.float32)
        self.n_edges = 0
        self._edge_keys = set()

    def add_vertex(self, Twc: np.ndarray) -> int:
        k = self.n_vertices
        if k >= self.max_vertices:
            # budget doubling: the reference's graph grows unboundedly
            self.Twc = np.concatenate(
                [self.Twc,
                 np.tile(np.eye(4, dtype=np.float32), (self.max_vertices, 1, 1))])
            self.max_vertices *= 2
        self.Twc[k] = Twc.astype(np.float32)
        self.n_vertices += 1
        if self.on_vertex is not None:
            self.on_vertex(k, self.Twc[k])
        return k

    def has_edge(self, a: int, b: int) -> bool:
        return a == b or (a, b) in self._edge_keys or (b, a) in self._edge_keys

    def add_edge(self, a: int, b: int, Z_ab: np.ndarray, weight: float = 1.0,
                 kind: int = 2):
        """Edge with measurement Z = T_{a<-b} (a = the "current" side).
        kind: provenance tag (1 = odometry, 2 = proximity, 3 = loop closure)
        for the multi-process publisher, no effect on the solve."""
        if self.n_edges >= self.max_edges:
            E = self.max_edges
            self.e_a = np.concatenate([self.e_a, np.zeros((E,), np.int32)])
            self.e_b = np.concatenate([self.e_b, np.zeros((E,), np.int32)])
            self.e_Z = np.concatenate(
                [self.e_Z, np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))])
            self.e_w = np.concatenate([self.e_w, np.zeros((E,), np.float32)])
            self.max_edges *= 2
        e = self.n_edges
        self.e_a[e] = a
        self.e_b[e] = b
        self.e_Z[e] = Z_ab.astype(np.float32)
        self.e_w[e] = weight * self.information
        self.n_edges += 1
        self._edge_keys.add((a, b))
        if self.on_edge is not None:
            self.on_edge(a, b, self.e_Z[e], float(weight), int(kind))

    def edges_spanning(self, lo: int, hi: int):
        """The (a, b) pairs of edges, of any kind, that tie a vertex below
        `lo` to a vertex at or above `hi`: how a revisit of the start was
        closed."""
        E = self.n_edges
        return [(int(a), int(b)) for a, b in zip(self.e_a[:E], self.e_b[:E])
                if min(a, b) < lo and max(a, b) >= hi]

    def add_odometry_edge(self, a: int, b: int):
        """setMeasurementFromState (Solver/PoseGraph.cpp:204): Z from the
        current estimates."""
        Z = se3.inverse_np(self.Twc[a]) @ self.Twc[b]
        self.add_edge(a, b, Z, kind=1)

    @staticmethod
    def _pad(n: int) -> int:
        p = 8
        while p < n:
            p *= 2
        return p

    def optimize(self, iterations: int = 10) -> np.ndarray:
        """Run the device solve; updates and returns Twc[:n_vertices]. One
        packed upload, one device-to-host copy of the solved poses. Like the
        reference it needs more than 5 vertices (Solver/PoseGraph.cpp:354).
        With a mesh of more than one shard the solve is the edge-sharded CG
        LM (parallel/dist_ba.py)."""
        K, E = self.n_vertices, self.n_edges
        if K <= 5:
            return self.Twc[:K]
        if self.on_solve is not None:
            # announce the solve to the backend peers before entering the
            # collectives (they join it with the same graph; mp_slam.py)
            self.on_solve(iterations, K, E)
        mesh = self.mesh if self.mesh is not None and self.mesh.size > 1 else None
        if mesh is not None and mesh.spans_processes:
            # a mesh across processes: every process holds the same full
            # graph on the host and uploads only its own shards of the edges
            from rgbdslam_tpu_torch.parallel.multihost import make_global, shard_edges_global

            edges = shard_edges_global(PoseGraphEdges(
                a=self.e_a[:E], b=self.e_b[:E], Z=self.e_Z[:E], weight=self.e_w[:E]), mesh)
            fixed = np.zeros((K,), bool)
            fixed[0] = True                                 # vertex 0 gauge
            Twc, fixed = make_global(self.Twc[:K], mesh, None), make_global(fixed, mesh, None)
        else:
            # everything the solve needs in one pinned upload
            blob = np.concatenate([
                self.Twc[:K].ravel(), self.e_Z[:E].ravel(), self.e_w[:E],
                self.e_a[:E].astype(np.float32), self.e_b[:E].astype(np.float32)])
            d = upload(blob.astype(np.float32), self.device)
            o = 0
            Twc = d[o:o + 16 * K].reshape(K, 4, 4)
            o += 16 * K
            Z = d[o:o + 16 * E].reshape(E, 4, 4)
            o += 16 * E
            w = d[o:o + E]
            a = d[o + E:o + 2 * E].to(torch.int64)
            b = d[o + 2 * E:o + 3 * E].to(torch.int64)
            edges = PoseGraphEdges(a=a, b=b, Z=Z, weight=w)
            fixed = torch.arange(K, device=self.device) == 0   # vertex 0 gauge
        if mesh is not None:
            # the distributed live path: the edges sharded over the mesh,
            # the normal equations summed over the shards in shard order,
            # the matrix-free CG inner solve
            from rgbdslam_tpu_torch.parallel.dist_ba import distributed_pose_graph_optimize_cg

            Twc_opt, _cost = distributed_pose_graph_optimize_cg(
                Twc, edges, fixed, mesh, iterations, self.cg_iters, self.huber_delta,
                self.lm_lambda0)
            self.dist_solves += 1
        elif self._pad(K) >= self.cg_threshold:
            # large maps: matrix-free preconditioned CG, O(K + E) memory
            from rgbdslam_tpu_torch.solvers.cg import optimize_pose_graph_cg

            Twc_opt, _cost = optimize_pose_graph_cg(
                Twc, edges, fixed, iterations, self.cg_iters, self.huber_delta,
                self.lm_lambda0)
        else:
            Twc_opt, _cost = optimize_pose_graph(
                Twc, edges, fixed, iterations, self.huber_delta, self.lm_lambda0)
        out = Twc_opt.cpu().numpy()
        self.Twc[:K] = out
        return out
