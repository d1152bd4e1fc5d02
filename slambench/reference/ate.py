"""Absolute trajectory error against the ground truth, after the
least-squares rigid alignment of the two sets of camera centres (Horn's and
Umeyama's closed form, as TUM's evaluate_ate.py), in float64."""

from __future__ import annotations

import numpy as np


def ate_rmse(est_twc: np.ndarray, gt_twc: np.ndarray) -> float:
    """RMSE in metres of the aligned camera centres of two (N, 4, 4) Twc
    sequences of the same frames."""
    src = np.asarray(est_twc, np.float64)[:, :3, 3]
    dst = np.asarray(gt_twc, np.float64)[:, :3, 3]
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    xs, xd = src - mu_s, dst - mu_d
    U, _, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    err = dst - (src @ R.T + (mu_d - R @ mu_s))
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))
