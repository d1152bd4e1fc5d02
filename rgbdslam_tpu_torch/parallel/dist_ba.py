"""Distributed pose-graph and bundle adjustment over a mesh of shards (port
of rgbdslam_tpu/parallel/dist_ba.py).

The reference is single-process (SURVEY.md section 2.7: no distributed
backend). The JAX package shards the O(E) work of the pose graph (the edges'
residuals, Jacobians and blocks) over a 1-D device mesh with `shard_map`,
reduces the normal equations with `psum` and solves the replicated system on
every device; bundle adjustment shards the landmark blocks instead.

Here the mesh is rgbdslam_tpu_torch.mesh.Mesh: an ordered tuple of torch
devices (a device may repeat, so one card or the CPU can hold several
shards) whose `psum` adds the shards' partials in shard order, in one
process or across several. The solvers are the plain ones of solvers/ run
over the shards (the plain solves are these on a mesh of one shard): this
module shards the edges and the landmarks and builds the mesh. The
replicated state (poses, the LM's lambda and cost) lives on the first
shard's device; each step reads nothing back to the host (0 host syncs a
solve in one process; across processes the collectives themselves wait).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rgbdslam_tpu_torch.device import resolve_device, visible_devices
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.mesh import Mesh
from rgbdslam_tpu_torch.solvers.ba import BAProblem, _schur_lm
from rgbdslam_tpu_torch.solvers.cg import _cg_lm
from rgbdslam_tpu_torch.solvers.pose_graph import (
    PoseGraphEdges,
    _dense_lm,
    edge_blocks,
    graph_cost,
)


def make_mesh(n_devices: Optional[int] = None, axis: str = "edges", device="cuda") -> Mesh:
    """1-D mesh over the visible devices of `device`'s type (the cards
    unless the caller asks for the CPU; no card raises), the first
    `n_devices` of them; `n_devices` beyond the visible count cycles over
    them, so one card or the CPU can hold several shards. In an initialised torch.distributed
    job it spans every process (the default group), each holding its own
    visible devices, as the JAX package's mesh over jax.devices(); its
    reductions then ride the job's collectives (with one process too)."""
    devs = visible_devices(resolve_device(device))
    if n_devices is not None:
        devs = [devs[i % len(devs)] for i in range(n_devices)]
    group = None
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    return Mesh(devs, axis, group)


def _pad_rows(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    if n == 0:
        return x
    pad = torch.full((n,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def _split(x: torch.Tensor, mesh: Mesh) -> list:
    """This process's row blocks of `x` (rows a multiple of the mesh size),
    each on its shard's device."""
    n = x.shape[0] // mesh.size
    return [x[s * n:(s + 1) * n].to(d) for s, d in zip(mesh.local_shards(), mesh.devices)]


def shard_edges(edges: PoseGraphEdges, mesh: Mesh, axis: str = "edges") -> tuple:
    """Pad E to a multiple of the mesh size (identity Z, weight 0: no effect
    on the solve) and split it into the mesh's contiguous edge shards.
    Returns this process's shards, one PoseGraphEdges on each shard's
    device."""
    E = edges.a.shape[0]
    pad = -E % mesh.size
    Z = edges.Z
    if pad:
        eye = torch.eye(4, dtype=Z.dtype, device=Z.device).expand(pad, 4, 4)
        Z = torch.cat([Z, eye])
    cols = [_split(_pad_rows(edges.a, pad, 0), mesh), _split(_pad_rows(edges.b, pad, 0), mesh),
            _split(Z, mesh), _split(_pad_rows(edges.weight, pad, 0.0), mesh)]
    return tuple(PoseGraphEdges(*parts) for parts in zip(*cols))


def _edge_shards(edges, mesh: Mesh) -> tuple:
    return shard_edges(edges, mesh) if isinstance(edges, PoseGraphEdges) else tuple(edges)


def distributed_pose_graph_optimize(
    Twc: torch.Tensor,
    edges,
    fixed: torch.Tensor,
    mesh: Mesh,
    iterations: int = 10,
    huber_delta: float = 1.0,
    lm_lambda0: float = 1e-4,
    axis: str = "edges",
    adaptive: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-sharded Levenberg-Marquardt: solvers.pose_graph's dense LM with
    each shard's edges on its device and H, g and the cost reduced by
    `mesh.psum` (H, g and the cost in one reduction, the candidate's cost in
    another).

    Twc (K, 4, 4) and fixed (K,) are replicated; `edges` are shard_edges'
    shards (or whole edges, sharded here). Returns (Twc_opt, final_cost) on
    the mesh's home device."""
    return _dense_lm(Twc, _edge_shards(edges, mesh), fixed, mesh, iterations, huber_delta,
                     lm_lambda0, adaptive, 6, edge_blocks, se3.exp, graph_cost)


def distributed_pose_graph_optimize_cg(
    Twc: torch.Tensor,
    edges,
    fixed: torch.Tensor,
    mesh: Mesh,
    iterations: int = 10,
    cg_iters: int = 50,
    huber_delta: float = 1.0,
    lm_lambda0: float = 1e-4,
    axis: str = "edges",
    adaptive: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-sharded Levenberg-Marquardt with a distributed matrix-free CG
    solve (adaptive lambda, masked accept/reject): solvers.cg's CG LM over
    the edge shards.

    The (6K)^2 Hessian is never built: each shard holds its edges' 6x6
    blocks and the replicated O(K) vectors; per CG iteration exactly one
    (K, 6) reduction, the matvec: 24K bytes an iteration against the dense
    variant's 144K^2. This is the solve that scales past ~1k keyframes
    (distributing Solver/PoseGraph.cpp:350-368's backend solve)."""
    return _cg_lm(Twc, _edge_shards(edges, mesh), fixed, mesh, iterations, cg_iters,
                  huber_delta, lm_lambda0, adaptive)


# ---------------------------------------------------------------------------
# Distributed landmark-Schur bundle adjustment: landmark blocks sharded
# ---------------------------------------------------------------------------


def shard_landmarks(problem, mesh: Mesh, axis: str = "edges") -> tuple:
    """Pad the BAProblem's landmark axis to a mesh multiple (padding slots
    are lm_valid False, no observation) and split the landmark-major tables
    into the mesh's landmark shards; the keyframe poses stay replicated.
    Returns this process's shards, one BAProblem on each shard's device."""
    L = problem.Xw.shape[0]
    pad = -L % mesh.size
    cols = {
        "Xw": _pad_rows(problem.Xw, pad, 0.0), "lm_valid": _pad_rows(problem.lm_valid, pad, False),
        "obs_kf": _pad_rows(problem.obs_kf, pad, 0), "obs_uv": _pad_rows(problem.obs_uv, pad, 0.0),
        "obs_valid": _pad_rows(problem.obs_valid, pad, False),
        "obs_z": _pad_rows(problem.obs_z, pad, 0.0)}
    split = {k: _split(v, mesh) for k, v in cols.items()}
    Tcw = mesh.replicate(problem.Tcw)
    return tuple(type(problem)(Tcw=Tcw[i], **{k: v[i] for k, v in split.items()})
                 for i in range(len(mesh.devices)))


def distributed_local_ba(
    cam,
    problem,
    fixed_kf: torch.Tensor,
    mesh: Mesh,
    iterations: int = 5,
    huber_delta: float = 2.45,
    lm_lambda0: float = 1e-4,
    axis: str = "edges",
    adaptive: bool = True,
    edges=None,
    edge_huber: float = 1.0,
):
    """Landmark-sharded Schur-complement Levenberg-Marquardt BA: solvers.ba's
    Schur LM over the landmark shards.

    Each shard owns an L/n share of the landmark blocks: residuals,
    Jacobians, the 3x3 landmark eliminations and its partial reduced camera
    system (6K x 6K, K the window, small), assembled by ba.py's one-hot
    products, then psum-reduced (with the cost, one reduction an
    iteration); the replicated solve follows, and each shard
    back-substitutes its own landmarks. `edges` (solvers.ba.BAEdges,
    replicated) folds the pose-graph relative factors in as local_ba's
    joint mode: computed once on the home device and added after the
    reduction (E << L). This is what the live _global_ba dispatches to on a
    mesh.

    `problem`: shard_landmarks' shards, or a whole BAProblem (sharded
    here). Returns (Tcw_opt (K, 4, 4), Xw_opt (L_padded, 3) in shard order,
    final cost), on the mesh's home device."""
    shards = shard_landmarks(problem, mesh) if isinstance(problem, BAProblem) else tuple(problem)
    return _schur_lm(cam, shards, fixed_kf, mesh, iterations, huber_delta, lm_lambda0, edges,
                     edge_huber, adaptive)


# ---------------------------------------------------------------------------
# Data-parallel frontend: a batch of frames over the shards
# ---------------------------------------------------------------------------


def batched_frontend(cam, cfg):
    """Returns fn(grays, depths) -> a list of B FrameFeatures, to be invoked
    with B-sharded inputs: a sequence of [b, H, W] blocks each, one a shard
    on its shard's device (`_split(x, mesh)` gives them). The whole feature
    pipeline (pyramid, detection, descriptors) runs per frame on its block's
    device, in shard order, with no collective."""
    from rgbdslam_tpu_torch.frontend.frame import build_frame_features

    def run(grays, depths):
        return [build_frame_features(cam, g[i], d[i], cfg)
                for g, d in zip(grays, depths) for i in range(g.shape[0])]

    return run
