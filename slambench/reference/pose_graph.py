"""Plain reference of the SE(3) pose-graph solve (g2o's EdgeSE3 graph as
toniortiz/rgbd-slam's Solver/PoseGraph.cpp builds it): vertex poses Twc,
edges with the measurement Z = T_{a<-b}, the residual log(Z^-1 Ta^-1 Tb),
a Huber kernel by reweighting, vertex 0 held by a strong prior, and
Levenberg-Marquardt with a dense solve, in float64 on the host.

Levenberg's schedule: the damping starts at `lam0`, scales the diagonal,
is divided by 3 after a step that lowers the robust cost and doubled after
one that does not, within [1e-9, 1e8]."""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference import geometry


def _residual(Ta, Tb, Z):
    return geometry.log_smooth(geometry.inverse(Z) @ geometry.inverse(Ta) @ Tb)


def _edge(Ta, Tb, Z):
    def f(x):
        E = geometry.exp(x.reshape(2, 6))
        return _residual(E[0] @ Ta, E[1] @ Tb, Z)

    x0 = torch.zeros(12, dtype=Ta.dtype)
    J = torch.func.jacfwd(f)(x0)
    return f(x0), J[:, :6], J[:, 6:]


def _cost(r_norm, w, delta):
    return torch.sum(w * torch.where(r_norm <= delta, r_norm * r_norm,
                                     2.0 * delta * r_norm - delta * delta))


def solve(Twc: np.ndarray, a: np.ndarray, b: np.ndarray, Z: np.ndarray, w: np.ndarray,
          iterations: int, huber_delta: float, lam0: float) -> np.ndarray:
    """The graph's vertices after `iterations` Levenberg-Marquardt steps
    from `Twc` (K, 4, 4); returns (K, 4, 4) float64."""
    X = torch.as_tensor(np.asarray(Twc, np.float64))
    Zt = torch.as_tensor(np.asarray(Z, np.float64))
    wt = torch.as_tensor(np.asarray(w, np.float64))
    at, bt = torch.as_tensor(np.asarray(a, np.int64)), torch.as_tensor(np.asarray(b, np.int64))
    K = X.shape[0]
    lam = lam0
    edges = torch.func.vmap(_edge)
    for _ in range(iterations):
        r, Ja, Jb = edges(X[at], X[bt], Zt)
        rn = torch.linalg.norm(r, dim=-1)
        cost = _cost(rn, wt, huber_delta)
        we = wt * torch.where(rn <= huber_delta, 1.0,
                              huber_delta / torch.clamp_min(rn, 1e-12))
        H = torch.zeros(K, K, 6, 6, dtype=X.dtype)
        g = torch.zeros(K, 6, dtype=X.dtype)
        blk = lambda A, B: torch.einsum("eij,eik,e->ejk", A, B, we)  # noqa: E731
        H.index_put_((at, at), blk(Ja, Ja), accumulate=True)
        H.index_put_((bt, bt), blk(Jb, Jb), accumulate=True)
        H.index_put_((at, bt), blk(Ja, Jb), accumulate=True)
        H.index_put_((bt, at), blk(Jb, Ja), accumulate=True)
        g.index_put_((at,), torch.einsum("eij,ei,e->ej", Ja, r, we), accumulate=True)
        g.index_put_((bt,), torch.einsum("eij,ei,e->ej", Jb, r, we), accumulate=True)
        Hm = H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
        boost = torch.full((6 * K,), lam + 1e-8, dtype=X.dtype)
        boost[:6] = 1e9
        Hm = Hm + torch.diag(boost) + lam * torch.diag(torch.diagonal(Hm))
        xi = -torch.linalg.solve(Hm, g.reshape(-1)).reshape(K, 6)
        xi[0] = 0.0
        X_new = geometry.exp(xi) @ X
        r_new = _residual(X_new[at], X_new[bt], Zt)
        if _cost(torch.linalg.norm(r_new, dim=-1), wt, huber_delta) < cost:
            X, lam = X_new, max(lam / 3.0, 1e-9)
        else:
            lam = min(lam * 2.0, 1e8)
    return X.numpy()
