"""Trajectory evaluation: ATE RMSE (Umeyama-aligned) and RPE.

The reference validates offline against TUM ground truth with external tools
(SURVEY.md §4; the best recorded result is the `0.058.png` screenshot). This
module is the measurement substrate for BASELINE.md's targets: a TUM-style
evaluator (equivalent to the standard `evaluate_ate.py` / `evaluate_rpe.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association between two trajectories."""
    ia, ib = [], []
    j = 0
    order = np.argsort(ts_b)
    ts_b_sorted = ts_b[order]
    for i, t in enumerate(ts_a):
        j = np.searchsorted(ts_b_sorted, t)
        best = None
        for k in (j - 1, j):
            if 0 <= k < len(ts_b_sorted):
                dt = abs(ts_b_sorted[k] - t)
                if dt <= max_dt and (best is None or dt < abs(ts_b_sorted[best] - t)):
                    best = k
        if best is not None:
            ia.append(i)
            ib.append(order[best])
    return np.asarray(ia, dtype=np.int64), np.asarray(ib, dtype=np.int64)


def align_umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares rigid (optionally similarity) alignment src -> dst.

    Returns (R, t, s) with dst ~ s * R @ src + t. Points are (N, 3).
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(
    ts_est: np.ndarray,
    poses_est: np.ndarray,
    ts_gt: np.ndarray,
    poses_gt: np.ndarray,
    max_dt: float = 0.02,
    with_scale: bool = False,
) -> Tuple[float, dict]:
    """Absolute trajectory error RMSE after timestamp association + alignment.

    Poses are Twc [N,4,4]. Returns (rmse, detail dict).
    """
    ia, ib = associate(np.asarray(ts_est), np.asarray(ts_gt), max_dt)
    if len(ia) < 2:
        return float("inf"), {"pairs": 0}
    p_est = poses_est[ia, :3, 3]
    p_gt = poses_gt[ib, :3, 3]
    finite = np.isfinite(p_est).all(axis=-1) & np.isfinite(p_gt).all(axis=-1)
    if finite.sum() < 2:
        return float("inf"), {"pairs": 0, "nonfinite": int((~finite).sum())}
    if not finite.all():
        p_est, p_gt = p_est[finite], p_gt[finite]
    R, t, s = align_umeyama(p_est, p_gt, with_scale)
    aligned = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(aligned - p_gt, axis=-1)
    return float(np.sqrt(np.mean(err ** 2))), {
        "pairs": int(len(ia)),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "scale": s,
    }


def rpe(
    ts_est: np.ndarray,
    poses_est: np.ndarray,
    ts_gt: np.ndarray,
    poses_gt: np.ndarray,
    delta: int = 1,
    max_dt: float = 0.02,
) -> Tuple[float, float]:
    """Relative pose error over a frame delta: (trans RMSE [m], rot RMSE [rad])."""
    ia, ib = associate(np.asarray(ts_est), np.asarray(ts_gt), max_dt)
    if len(ia) <= delta:
        return float("inf"), float("inf")
    Te = poses_est[ia]
    Tg = poses_gt[ib]
    errs_t, errs_r = [], []
    for i in range(len(ia) - delta):
        de = np.linalg.inv(Te[i]) @ Te[i + delta]
        dg = np.linalg.inv(Tg[i]) @ Tg[i + delta]
        E = np.linalg.inv(dg) @ de
        errs_t.append(np.linalg.norm(E[:3, 3]))
        c = np.clip(0.5 * (np.trace(E[:3, :3]) - 1.0), -1.0, 1.0)
        errs_r.append(np.arccos(c))
    return float(np.sqrt(np.mean(np.square(errs_t)))), float(
        np.sqrt(np.mean(np.square(errs_r)))
    )
