"""The fused RANSAC kernels and the gated matcher of rgbdslam_tpu_torch,
held on the CPU through a step-by-step PyTorch model of what the CUDA code
does (csrc/mahal.cu kernels A and B, csrc/hamming.cu's gate kernel).

The model is written as the kernels are: the valid slots ranked by a scan
and each draw looked up by its rank, the per-hypothesis Horn fit with
explicit sums and 30 power iterations (no einsum, no matmul), the block
arg max as a sequential scan with the first index on ties and NaN on top,
the refit loop without re-scoring the pose it starts from. It is held
against the port's plain version (`ransac_se3_ref` and its two halves) and
against the JAX package with injected draws.

Tolerances, each with its reason:
- hypothesis poses, atol 5e-5: 30 power iterations summed in another order
  (the bound tests/test_torch_ransac.py holds between torch and XLA); four
  draws of one slot give S = 0 and a NaN pose in every version (0 / 0 in
  the quaternion's normalization), which scores no inlier: NaN equals NaN;
- counts exact and sums of m^2 rtol 1e-5 against the plain scorer fed the
  model's own poses: same operation order per correspondence, only the
  order of the float sum differs;
- the second half and the whole: `success` equal, inlier count within 2,
  T21 rtol 1e-4 / atol 5e-5. The refits' sums run in another order, so a
  correspondence on the threshold can change sides.
The gates are integers and masks: exact.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.config import RansacConfig as JRansacConfig
from rgbdslam_tpu.frontend import matcher as jmatch
from rgbdslam_tpu_torch.config import RansacConfig
from rgbdslam_tpu_torch.frontend import matcher as tmatch
from rgbdslam_tpu_torch.ops import kernels
from rgbdslam_tpu_torch.solvers import ransac_se3 as transac
from rgbdslam_tpu_torch.solvers.kabsch import weighted_rigid_transform
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

jransac = importlib.import_module("rgbdslam_tpu.solvers.ransac_se3")

F32 = torch.float32
KEY = jax.random.PRNGKey(42)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def model_horn_pose(S, c1, c2, wsum):
    """horn_pose of csrc/mahal.cu over leading dimensions: S (..., 9)
    row-major normalized cross-covariance, centroids (..., 3), weight sum
    (...). Returns (R (..., 9), t (..., 3))."""
    Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz = S.unbind(-1)
    M = [[Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
         [None, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
         [None, None, -Sxx + Syy - Szz, Syz + Szy],
         [None, None, None, -Sxx - Syy + Szz]]
    for i in range(1, 4):
        for j in range(i):
            M[i][j] = M[j][i]
    shift = None
    for i in range(4):
        row = M[i][0].abs() + M[i][1].abs() + M[i][2].abs() + M[i][3].abs()
        shift = row if shift is None else torch.where(row > shift, row, shift)
    for i in range(4):
        M[i][i] = M[i][i] + shift
    q = [torch.full_like(wsum, v) for v in (1.0, 0.03, 0.02, 0.01)]
    n0 = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    q = [qi / n0 for qi in q]
    for _ in range(30):
        v = [M[i][0] * q[0] + M[i][1] * q[1] + M[i][2] * q[2] + M[i][3] * q[3]
             for i in range(4)]
        nrm = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3])
        den = torch.where(nrm < 1e-20, torch.full_like(nrm, 1e-20), nrm)
        q = [vi / den for vi in v]
    nq = torch.sqrt(q[1] * q[1] + q[2] * q[2] + q[3] * q[3] + q[0] * q[0])
    x, y, z, w = q[1] / nq, q[2] / nq, q[3] / nq, q[0] / nq
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    R = [1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
         2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
         2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)]
    t = [c2[..., i] - (R[3 * i] * c1[..., 0] + R[3 * i + 1] * c1[..., 1]
                       + R[3 * i + 2] * c1[..., 2]) for i in range(3)]
    R, t = torch.stack(R, -1), torch.stack(t, -1)
    degenerate = (wsum <= 1e-12)[..., None]
    eye = torch.eye(3, dtype=F32).reshape(9)
    return torch.where(degenerate, eye, R), torch.where(degenerate, torch.zeros(3), t)


def _pose_matrix(R, t):
    T = torch.zeros(R.shape[:-1] + (4, 4), dtype=F32)
    T[..., :3, :3] = R.reshape(R.shape[:-1] + (3, 3))
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def _sigma(z, cfg):
    """sigma_diag of csrc/mahal.cu: (cov_x z, cov_y z, (dsf z z)^2)."""
    cov_x, cov_y = transac._raster_cov(cfg)
    sz = cfg.depth_std_factor * z * z
    return torch.stack([cov_x * z, cov_y * z, sz * sz], -1)


def _model_pair(T, p1, p2, cfg, cam=None):
    """pair_inlier of csrc/mahal.cu for poses T (..., 4, 4) on one problem:
    (inlier test before validity (..., N), error (..., N)). Mahalanobis: m^2
    in the kernels' order; the others: q = R p1 + t summed left to right,
    delta = sqrt((dx^2 + dy^2) + dz^2), error delta^2, and the model's test
    (reprojection: both depths clamped at 1e-6)."""
    if cfg.error_model == "mahalanobis":
        m2 = transac.mahalanobis_sq_planes(T, p1, p2, _sigma(p1[:, 2], cfg),
                                           _sigma(p2[:, 2], cfg))
        return m2 <= cfg.max_mahalanobis * cfg.max_mahalanobis, m2
    lead = T.shape[:-2]
    x1, y1, z1 = (p1[:, k].expand(lead + p1.shape[:1]) for k in range(3))
    x2, y2, z2 = (p2[:, k].expand(lead + p2.shape[:1]) for k in range(3))
    r = [[T[..., i, j, None] for j in range(4)] for i in range(3)]
    q = [r[i][0] * x1 + r[i][1] * y1 + r[i][2] * z1 + r[i][3] for i in range(3)]
    d0, d1, d2 = q[0] - x2, q[1] - y2, q[2] - z2
    delta = torch.sqrt(d0 * d0 + d1 * d1 + d2 * d2)
    if cfg.error_model == "euclidean":
        ok = delta <= cfg.inlier_threshold_m
    elif cfg.error_model == "adaptive_euclidean":
        zm = 0.5 * (z1 + z2)
        ok = delta <= cfg.inlier_threshold_m + cfg.adaptive_depth_coeff * zm * zm
    else:
        zq = torch.where(q[2] < 1e-6, torch.full_like(q[2], 1e-6), q[2])
        zt = torch.where(z2 < 1e-6, torch.full_like(z2, 1e-6), z2)
        du = (cam.fx * q[0] / zq + cam.cx) - (cam.fx * x2 / zt + cam.cx)
        dv = (cam.fy * q[1] / zq + cam.cy) - (cam.fy * y2 / zt + cam.cy)
        ok = torch.sqrt(du * du + dv * dv) <= cfg.reproj_threshold_px
        if cfg.error_model == "both":
            ok = ok & (delta <= cfg.inlier_threshold_m)
    return ok, delta * delta


def _model_score(T, p1, p2, valid, cfg, cam=None):
    """(inlier flags, count, sum of errors) of poses T (..., 4, 4) on one
    problem under cfg.error_model."""
    ok, err = _model_pair(T, p1, p2, cfg, cam)
    ok = ok & valid
    return ok, ok.sum(-1).to(torch.int32), torch.where(ok, err, 0.0).sum(-1)


def model_kernel_a(p1, p2, w, valid, cfg, u=None, draws=None, cam=None):
    """Kernel A on one problem: (T_h (H, 4, 4), count (H,), sum of errors
    (H,), the sampled slots (H, S)). Thread 0's fit walks the S slots once
    for the weight sum, once for the centroids, once for the
    cross-covariance, each sum left to right."""
    n_valid = int(valid.sum())
    nv = max(n_valid, 1)
    if draws is None:
        draws = torch.clamp_max(torch.floor(u * float(nv)).to(torch.int64), nv - 1)
    draws = draws.to(torch.int64)
    # the slot of rank d among the valid ones; a draw beyond them takes slot 0
    slots = torch.nonzero(valid)[:, 0]
    in_range = (draws >= 0) & (draws < n_valid)
    idx = torch.zeros_like(draws)
    if n_valid:
        idx = torch.where(in_range, slots[draws.clamp(0, n_valid - 1)], idx)
    x1, x2 = p1[idx], p2[idx]                         # (H, S, 3)
    sw = w[idx] * valid[idx].to(F32)
    n_s = idx.shape[1]
    wsum = torch.zeros(idx.shape[0])
    for s in range(n_s):
        wsum = wsum + sw[:, s]
    den = torch.where(wsum < 1e-12, torch.full_like(wsum, 1e-12), wsum)
    wn = sw / den[:, None]
    c1 = torch.zeros(idx.shape[0], 3)
    c2 = torch.zeros(idx.shape[0], 3)
    for s in range(n_s):
        c1 = c1 + wn[:, s, None] * x1[:, s]
        c2 = c2 + wn[:, s, None] * x2[:, s]
    S = torch.zeros(idx.shape[0], 9)
    for s in range(n_s):
        q1, q2 = x1[:, s] - c1, x2[:, s] - c2
        S = S + torch.stack([wn[:, s] * q1[:, a] * q2[:, b]
                             for a in range(3) for b in range(3)], -1)
    T_h = _pose_matrix(*model_horn_pose(S, c1, c2, wsum))
    T_h[0] = torch.eye(4)
    _, cnt, err = _model_score(T_h, p1, p2, valid, cfg, cam)
    return T_h, cnt, err, idx


def _rmse(cnt, err):
    return math.sqrt(err / max(cnt, 1)) if cnt >= 3 else 1e9


def model_argmax(cnt_h, err_h):
    """Kernel B's selection: rank in f32, the larger rank ahead, NaN above
    everything, the lower index among equals."""
    f = np.float32
    best, best_rank = None, None
    for k in range(len(cnt_h)):
        c, e = int(cnt_h[k]), f(err_h[k])
        rm = np.sqrt(e / f(max(c, 1)), dtype=f) if c >= 3 else f(1e9)
        rank = f(f(c) * f(1e4)) - (f(9e3) if rm > f(9e3) else rm)
        ahead = best is None or (np.isnan(rank) and not np.isnan(best_rank)) or (
            not np.isnan(rank) and not np.isnan(best_rank) and rank > best_rank)
        if ahead:
            best, best_rank = k, rank
    return best


def model_polish(T, p1, p2, inl, cfg):
    """The Mahalanobis polish of kernel B: mahalanobis_refine_iters rounds,
    each point's covariance C = R diag(s1) R^T + diag(s2) entry by entry,
    its Cholesky factor with every pivot floored at 1e-20, forward
    substitution for the whitened residual and the six Jacobian columns
    [e0 e1 e2 | (0, -q2, q1) (q2, 0, -q0) (-q1, q0, 0)], the 21 + 6 sums
    over the inliers, H + 1e-6 I solved with pivoting, exp(xi) T. Kept where
    finite with >= 3 inliers, else T."""
    from rgbdslam_tpu_torch.geometry import se3 as tse3

    a, b = _sigma(p1[:, 2], cfg), _sigma(p2[:, 2], cfg)
    wm = inl.to(F32)
    T0 = T
    for _ in range(cfg.mahalanobis_refine_iters):
        R, t = T[:3, :3], T[:3, 3]
        q = [R[i, 0] * p1[:, 0] + R[i, 1] * p1[:, 1] + R[i, 2] * p1[:, 2] + t[i]
             for i in range(3)]
        d = [q[i] - p2[:, i] for i in range(3)]
        C = [[R[i, 0] * a[:, 0] * R[l, 0] + R[i, 1] * a[:, 1] * R[l, 1]
              + R[i, 2] * a[:, 2] * R[l, 2] + (b[:, i] if i == l else 0.0)
              for l in range(3)] for i in range(3)]
        l11 = torch.sqrt(torch.clamp_min(C[0][0], 1e-20))
        l21, l31 = C[1][0] / l11, C[2][0] / l11
        l22 = torch.sqrt(torch.clamp_min(C[1][1] - l21 * l21, 1e-20))
        l32 = (C[2][1] - l31 * l21) / l22
        l33 = torch.sqrt(torch.clamp_min(C[2][2] - l31 * l31 - l32 * l32, 1e-20))

        def fwd(b0, b1, b2):
            y0 = b0 / l11
            y1 = (b1 - l21 * y0) / l22
            return y0, y1, (b2 - l31 * y0 - l32 * y1) / l33

        zero, one = torch.zeros_like(q[0]), torch.ones_like(q[0])
        Wd = fwd(*d)
        WJ = [fwd(one, zero, zero), fwd(zero, one, zero), fwd(zero, zero, one),
              fwd(zero, -q[2], q[1]), fwd(q[2], zero, -q[0]), fwd(-q[1], q[0], zero)]
        H = torch.zeros(6, 6)
        g = torch.zeros(6)
        for j in range(6):
            for k in range(j, 6):
                H[j, k] = H[k, j] = ((WJ[j][0] * WJ[k][0] + WJ[j][1] * WJ[k][1]
                                      + WJ[j][2] * WJ[k][2]) * wm).sum()
            g[j] = ((WJ[j][0] * Wd[0] + WJ[j][1] * Wd[1] + WJ[j][2] * Wd[2]) * wm).sum()
        xi = -torch.linalg.solve_ex(H + 1e-6 * torch.eye(6), g[:, None])[0][:, 0]
        T = tse3.exp(xi) @ T
    ok = bool(torch.isfinite(T).all()) and int(inl.sum()) >= 3
    return T if ok else T0


def model_kernel_b(T_h, cnt_h, err_h, p1, p2, w, valid, cfg, cam=None):
    """Kernel B on one problem: (T21, inliers, count, rmse, success)."""
    best = model_argmax(cnt_h.numpy(), err_h.numpy())
    T = T_h[best]
    inl, cnt, err = _model_score(T, p1, p2, valid, cfg, cam)
    cnt, rmse = int(cnt), _rmse(int(cnt), float(err))
    for _ in range(cfg.refine_iters):
        wi = w * inl.to(F32)
        wsum = wi.sum()
        den = torch.where(wsum < 1e-12, torch.full_like(wsum, 1e-12), wsum)
        wn = wi / den
        c1 = torch.stack([(wn * p1[:, k]).sum() for k in range(3)])
        c2 = torch.stack([(wn * p2[:, k]).sum() for k in range(3)])
        q1, q2 = p1 - c1, p2 - c2
        S = torch.stack([(wn * q1[:, a] * q2[:, b]).sum()
                         for a in range(3) for b in range(3)])
        T_new = _pose_matrix(*model_horn_pose(S, c1, c2, wsum))
        inl2, cnt2, err2 = _model_score(T_new, p1, p2, valid, cfg, cam)
        cnt2, rmse2 = int(cnt2), _rmse(int(cnt2), float(err2))
        if cnt2 >= cnt and rmse2 <= rmse:
            T, inl, cnt, rmse = T_new, inl2, cnt2, rmse2
    if cfg.mahalanobis_refine:
        T_m = model_polish(T, p1, p2, inl, cfg)
        inl2, cnt2, err2 = _model_score(T_m, p1, p2, valid, cfg, cam)
        cnt2, rmse2 = int(cnt2), _rmse(int(cnt2), float(err2))
        if cnt2 >= cnt and rmse2 <= rmse:
            T, inl, cnt, rmse = T_m, inl2, cnt2, rmse2
    success = cnt >= cfg.min_inliers and bool(valid.any())
    return T, inl & success, cnt, rmse, success


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------


def _se3_exp(xi):
    return np.asarray(jax.vmap(importlib.import_module("rgbdslam_tpu.geometry.se3").exp)(
        jnp.asarray(xi)))


def _problem(rng, N, outliers=0.3, p_valid=0.8):
    p1 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    p1[:, 2] = rng.uniform(0.5, 4.0, N)
    T_true = _se3_exp(rng.normal(scale=0.05, size=(1, 6)).astype(np.float32))[0]
    p2 = (p1 @ T_true[:3, :3].T + T_true[:3, 3]
          + rng.normal(scale=0.004, size=(N, 3))).astype(np.float32)
    bad = rng.uniform(size=N) < outliers
    p2[bad] += rng.normal(scale=0.5, size=(int(bad.sum()), 3)).astype(np.float32)
    valid = rng.uniform(size=N) < p_valid
    w = np.where(valid, 1.0 / (p1[:, 2] * p2[:, 2]), 0.0).astype(np.float32)
    return p1, p2, w, valid


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a).copy()) for a in arrays]


def _case(name):
    """(list of problems, H): every problem is (p1, p2, w, valid, draws)."""
    seeds = {"unbatched": 0, "batch13": 1, "ragged": 2, "few_inliers": 3}
    rng = np.random.default_rng(100 + seeds[name])
    H = 64
    if name == "unbatched":
        probs = [_problem(rng, 512)]
    elif name == "batch13":
        probs = [_problem(rng, 256, outliers=0.2 + 0.03 * i) for i in range(13)]
        for i in (4, 9):                       # padded candidates: no valid slot
            p1, p2, w, valid = probs[i]
            probs[i] = (p1, p2, np.zeros_like(w), np.zeros_like(valid))
    elif name == "ragged":
        probs = [_problem(rng, 300)]           # N not a multiple of 256
    else:
        p1, p2, w, valid = _problem(rng, 256)
        valid[np.flatnonzero(valid)[2:]] = False       # two valid slots: under 3 inliers
        probs = [(p1, p2, np.where(valid, w, 0.0).astype(np.float32), valid)]
    out = []
    for p1, p2, w, valid in probs:
        # the draws the JAX function makes from KEY (jax.random's bits
        # cannot be reproduced in torch: both sides get these)
        draws = np.asarray(jax.random.randint(KEY, (H, 4), 0, max(int(valid.sum()), 1)))
        out.append((p1, p2, w, valid, draws))
    return out, H


CASES = ["unbatched", "batch13", "ragged", "few_inliers"]


def _model_run(prob, cfg):
    p1, p2, w, valid, draws = _t(*prob)
    T_h, cnt_h, err_h, _ = model_kernel_a(p1, p2, w, valid, cfg, draws=draws)
    return (T_h, cnt_h, err_h), model_kernel_b(T_h, cnt_h, err_h, p1, p2, w, valid, cfg)


def _same_result(model, T, inliers, num_inliers, success):
    mT, minl, mcnt, _, msuccess = model
    assert msuccess == bool(success)
    assert abs(mcnt - int(num_inliers)) <= 2
    assert int((minl.numpy() != np.asarray(inliers)).sum()) <= 2
    np.testing.assert_allclose(mT.numpy(), np.asarray(T), rtol=1e-4, atol=5e-5)


# ---------------------------------------------------------------------------
# the model against the plain version, held apart
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_model_kernel_a_matches_plain_fit_and_scorer(case):
    probs, H = _case(case)
    cfg = RansacConfig(num_hypotheses=H)
    for prob in probs:
        p1, p2, w, valid, draws = _t(*prob)
        T_h, cnt_h, err_h, idx = model_kernel_a(p1, p2, w, valid, cfg, draws=draws)
        plain = weighted_rigid_transform(p1[idx], p2[idx], w[idx] * valid[idx])
        plain[0] = torch.eye(4)
        torch.testing.assert_close(T_h, plain, rtol=0, atol=5e-5, equal_nan=True)
        pT, pcnt, perr = transac.hypotheses_ref(p1, p2, w, valid, cfg, draws=draws)
        torch.testing.assert_close(T_h, pT, rtol=0, atol=5e-5, equal_nan=True)
        s1, s2 = transac._sigma_diag(p1[:, 2], cfg), transac._sigma_diag(p2[:, 2], cfg)
        scnt, serr = kernels.mahal_hypothesis_scores_ref(T_h, p1, p2, s1, s2, valid, 9.0)
        assert torch.equal(cnt_h, scnt)
        torch.testing.assert_close(err_h, serr, rtol=1e-5, atol=0.0)
        if not valid.any():
            assert torch.equal(T_h, torch.eye(4).expand(H, 4, 4)) and int(cnt_h.sum()) == 0


@pytest.mark.parametrize("case", CASES)
def test_model_kernel_b_matches_plain_refits_on_same_inputs(case):
    probs, H = _case(case)
    cfg = RansacConfig(num_hypotheses=H)
    for prob in probs:
        p1, p2, w, valid, _ = _t(*prob)
        (T_h, cnt_h, err_h), model = _model_run(prob, cfg)
        ref = transac.select_refine_ref(T_h, cnt_h, err_h, p1, p2, w, valid, cfg)
        _same_result(model, ref.T21, ref.inliers, ref.num_inliers, ref.success)
        if model[2] >= 3:
            np.testing.assert_allclose(model[3], float(ref.rmse), rtol=1e-4)
        else:
            assert model[3] == float(ref.rmse) == 1e9


@pytest.mark.parametrize("case", CASES)
def test_model_matches_plain_ransac(case):
    """End to end against ransac_se3_ref with the same draws; the batch goes
    through the plain version as one batched call."""
    probs, H = _case(case)
    cfg = RansacConfig(num_hypotheses=H)
    stacked = [torch.stack(x) for x in zip(*(_t(*p) for p in probs))]
    ref = transac.ransac_se3_ref(*stacked[:4], None, cfg, draws=stacked[4])
    for i, prob in enumerate(probs):
        _, model = _model_run(prob, cfg)
        _same_result(model, ref.T21[i], ref.inliers[i], ref.num_inliers[i], ref.success[i])
    if case == "batch13":
        assert ref.success.tolist() == [i not in (4, 9) for i in range(13)]
    if case == "few_inliers":
        assert not bool(ref.success[0]) and float(ref.rmse[0]) == 1e9


@pytest.mark.parametrize("case", CASES)
def test_model_matches_jax_ransac(case):
    probs, H = _case(case)
    cfg_t, cfg_j = RansacConfig(num_hypotheses=H), JRansacConfig(num_hypotheses=H)
    for prob in probs:
        _, model = _model_run(prob, cfg_t)
        p1, p2, w, valid, _ = prob
        rj = jransac.ransac_se3(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w),
                                jnp.asarray(valid), KEY, cfg_j)
        _same_result(model, rj.T21, rj.inliers, rj.num_inliers, rj.success)


def test_model_uniforms_become_the_plain_versions_draws():
    rng = np.random.default_rng(7)
    cfg = RansacConfig(num_hypotheses=64)
    p1, p2, w, valid = _t(*_problem(rng, 300))
    u = torch.from_numpy(rng.uniform(size=(64, 4)).astype(np.float32))
    u[1] = float(np.nextafter(np.float32(1.0), np.float32(0.0)))   # clamps to n_valid - 1
    T_h, cnt_h, err_h, idx = model_kernel_a(p1, p2, w, valid, cfg, u=u)
    pT, pcnt, perr = transac.hypotheses_ref(p1, p2, w, valid, cfg, u=u)
    torch.testing.assert_close(T_h, pT, rtol=0, atol=5e-5, equal_nan=True)
    assert bool(valid[idx[1:]].all()) and int(idx[1, 0]) == int(torch.nonzero(valid)[-1])


def test_model_argmax_breaks_ties_like_torch():
    """rank = count * 1e4 - min(rmse, 9e3) in f32 rounds rmse away at high
    counts, so equal ranks are common: first index wins, NaN is the max."""
    cnt = torch.tensor([2, 900, 900, 900, 5, 0, 900], dtype=torch.int32)
    err = torch.tensor([0.1, 450.0, 449.9, 450.0, 1.0, 0.0, 460.0])
    rank = cnt.to(F32) * 1e4 - torch.clamp_max(transac._rmse(cnt, err), 9e3)
    assert rank[1] == rank[2] == rank[3]
    assert model_argmax(cnt.numpy(), err.numpy()) == int(torch.argmax(rank)) == 1
    err[3] = float("nan")
    rank = cnt.to(F32) * 1e4 - torch.clamp_max(transac._rmse(cnt, err), 9e3)
    assert model_argmax(cnt.numpy(), err.numpy()) == int(torch.argmax(rank)) == 3
    few = torch.tensor([1, 2, 0], dtype=torch.int32)
    assert model_argmax(few.numpy(), np.zeros(3, np.float32)) == 1


# ---------------------------------------------------------------------------
# dispatch and the wrapper's refusals
# ---------------------------------------------------------------------------


def test_ransac_on_cpu_is_the_plain_version_and_the_wrapper_refuses():
    rng = np.random.default_rng(5)
    p1, p2, w, valid = _t(*_problem(rng, 256))
    cfg = RansacConfig(num_hypotheses=32)
    draws = torch.from_numpy(rng.integers(0, int(valid.sum()), size=(32, 4)))
    kernels.reset_launch_counts()
    a = transac.ransac_se3(p1, p2, w, valid, None, cfg, draws=draws)
    b = transac.ransac_se3_ref(p1, p2, w, valid, None, cfg, draws=draws)
    assert torch.equal(a.T21, b.T21) and torch.equal(a.inliers, b.inliers)
    assert kernels.LAUNCHES["ransac_se3_fused"] == 0
    with pytest.raises(ValueError):          # CPU tensors: no fallback in the wrapper
        transac.ransac_se3_cuda(p1, p2, w, valid, cfg, draws=draws)
    # sample sizes other than 4, the other error models and the polish run
    # on the CPU as the plain version; the wrapper still takes CUDA tensors
    # only
    draws3 = draws[:, :3].contiguous()
    for ok, d in ((RansacConfig(num_hypotheses=32, sample_size=3), draws3),
                  (RansacConfig(num_hypotheses=32, error_model="euclidean"), draws),
                  (RansacConfig(num_hypotheses=32, mahalanobis_refine=True), draws)):
        a = transac.ransac_se3(p1, p2, w, valid, None, ok, draws=d)
        b = transac.ransac_se3_ref(p1, p2, w, valid, None, ok, draws=d)
        assert torch.equal(a.T21, b.T21) and bool(a.success)
        with pytest.raises(ValueError, match="CUDA"):
            transac.ransac_se3_cuda(p1, p2, w, valid, ok, draws=d)
    assert kernels.LAUNCHES["ransac_se3_fused"] == 0
    for bad in (RansacConfig(error_model="reprojection"), RansacConfig(error_model="both")):
        with pytest.raises(ValueError, match="camera"):
            transac.ransac_se3(p1, p2, w, valid, None, bad, draws=draws)
    with pytest.raises(ValueError, match="unknown"):
        transac.ransac_se3(p1, p2, w, valid, None, RansacConfig(error_model="l1"), draws=draws)


# ---------------------------------------------------------------------------
# the configurations: any S, every error model, the polish
# ---------------------------------------------------------------------------


MODEL_CONFIGS = {"S3": dict(sample_size=3), "S5": dict(sample_size=5),
                 "euclidean": dict(error_model="euclidean"),
                 "adaptive_euclidean": dict(error_model="adaptive_euclidean"),
                 "reprojection": dict(error_model="reprojection"),
                 "both": dict(error_model="both"),
                 "polish": dict(mahalanobis_refine=True)}


def _cams(cfg):
    """(the port's camera, the JAX package's) for the reprojection models."""
    if cfg.error_model not in ("reprojection", "both"):
        return None, None
    from rgbdslam_tpu.geometry.camera import SYNTHETIC as JSYNTHETIC
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC

    return SYNTHETIC, JSYNTHETIC


def _config_case(name, case):
    """(problems with (H, S) draws from KEY, the port's config, JAX's)."""
    probs, H = _case(case)
    kw = dict(num_hypotheses=H, **MODEL_CONFIGS[name])
    S = kw.get("sample_size", 4)
    out = [(p1, p2, w, valid,
            np.asarray(jax.random.randint(KEY, (H, S), 0, max(int(valid.sum()), 1))))
           for p1, p2, w, valid, _ in probs]
    return out, RansacConfig(**kw), JRansacConfig(**kw)


@pytest.mark.parametrize("name", list(MODEL_CONFIGS))
@pytest.mark.parametrize("case", ["unbatched", "batch13"])
def test_config_model_matches_plain(name, case):
    """Kernels A and B at S = 3 and 5, under every error model and with the
    polish, modelled, against the plain halves and the whole plain version
    (batched as one call): poses atol 5e-5, kernel A's counts exact and
    sums rtol 1e-5 against the plain scoring of its own poses, the rest as
    `_same_result`."""
    probs, cfg, _ = _config_case(name, case)
    cam, _ = _cams(cfg)
    models = []
    for prob in probs:
        p1, p2, w, valid, draws = _t(*prob)
        T_h, cnt_h, err_h, idx = model_kernel_a(p1, p2, w, valid, cfg, draws=draws, cam=cam)
        assert idx.shape == draws.shape
        pT, pcnt, perr = transac.hypotheses_ref(p1, p2, w, valid, cfg, draws=draws, cam=cam)
        torch.testing.assert_close(T_h, pT, rtol=0, atol=5e-5, equal_nan=True)
        ok, err = transac.pair_errors(T_h, p1, p2, cfg, cam)
        inl = ok & valid
        assert torch.equal(cnt_h, inl.sum(-1).to(torch.int32))
        torch.testing.assert_close(err_h, torch.where(inl, err, 0.0).sum(-1), rtol=1e-5,
                                   atol=1e-6)
        model = model_kernel_b(T_h, cnt_h, err_h, p1, p2, w, valid, cfg, cam)
        ref = transac.select_refine_ref(T_h, cnt_h, err_h, p1, p2, w, valid, cfg, cam)
        _same_result(model, ref.T21, ref.inliers, ref.num_inliers, ref.success)
        models.append(model)
    stacked = [torch.stack(x) for x in zip(*(_t(*p) for p in probs))]
    whole = transac.ransac_se3_ref(*stacked[:4], None, cfg, draws=stacked[4], cam=cam)
    for i, model in enumerate(models):
        _same_result(model, whole.T21[i], whole.inliers[i], whole.num_inliers[i],
                     whole.success[i])
    if case == "batch13":          # the two padded candidates fail, most others succeed
        assert not bool(whole.success[4]) and not bool(whole.success[9])
        assert int(whole.success.sum()) >= 9


@pytest.mark.parametrize("name", list(MODEL_CONFIGS))
def test_config_model_matches_jax(name):
    """The model against the JAX package's ransac_se3 with its own draws
    (the camera passed where the model needs one), as `_same_result`: the
    inlier count within 2 covers a correspondence whose error lies on the
    threshold, which XLA's CPU code, contracting into FMAs, may put on the
    other side."""
    probs, cfg_t, cfg_j = _config_case(name, "unbatched")
    cam_t, cam_j = _cams(cfg_t)
    for prob in probs:
        _, model = _model_run_cfg(prob, cfg_t, cam_t)
        p1, p2, w, valid, _ = prob
        rj = jransac.ransac_se3(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w),
                                jnp.asarray(valid), KEY, cfg_j, cam_j)
        _same_result(model, rj.T21, rj.inliers, rj.num_inliers, rj.success)
        assert model[4]


def _model_run_cfg(prob, cfg, cam):
    p1, p2, w, valid, draws = _t(*prob)
    T_h, cnt_h, err_h, _ = model_kernel_a(p1, p2, w, valid, cfg, draws=draws, cam=cam)
    return (T_h, cnt_h, err_h), model_kernel_b(T_h, cnt_h, err_h, p1, p2, w, valid, cfg, cam)


@pytest.mark.parametrize("seed", [0, 1])
def test_polish_matches_jax_refine_mahalanobis(seed):
    """The polish (the model of kernel B's rounds and the plain
    refine_mahalanobis_ref) against JAX's refine_mahalanobis from the same
    start and inliers: rtol 1e-4 / atol 5e-5 (f32 sums, triangular solves
    and a 6x6 solve in three orders over five rounds); the polish moves the
    pose."""
    rng = np.random.default_rng(300 + seed)
    p1, p2, w, valid = _problem(rng, 400, outliers=0.0, p_valid=1.0)
    p2 = p2 + (rng.normal(size=p2.shape) * (0.002 * p2[:, 2:] ** 2)).astype(np.float32)
    inl = valid & (rng.uniform(size=400) < 0.9)
    T0 = np.eye(4, dtype=np.float32)
    cfg_t, cfg_j = RansacConfig(), JRansacConfig()
    Tj = np.asarray(jransac.refine_mahalanobis(jnp.asarray(T0), jnp.asarray(p1),
                                               jnp.asarray(p2), jnp.asarray(inl), cfg_j, 5))
    tp1, tp2, tinl, tT0 = _t(p1, p2, inl, T0)
    Tm = model_polish(tT0, tp1, tp2, tinl, cfg_t)
    Tp = transac.refine_mahalanobis_ref(tT0, tp1, tp2, tinl, cfg_t, 5)
    np.testing.assert_allclose(Tm.numpy(), Tj, rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(Tp.numpy(), Tj, rtol=1e-4, atol=5e-5)
    assert float(np.abs(Tj - T0).max()) > 1e-3
    # fewer than three inliers: the start comes back
    few = np.zeros(400, bool)
    few[:2] = True
    np.testing.assert_array_equal(
        transac.refine_mahalanobis_ref(tT0, tp1, tp2, torch.from_numpy(few), cfg_t).numpy(), T0)


def test_reprojection_without_camera_raises_in_both_packages():
    rng = np.random.default_rng(9)
    p1, p2, w, valid = _problem(rng, 64)
    for model in ("reprojection", "both"):
        with pytest.raises(ValueError, match="camera"):
            jransac.ransac_se3(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w),
                               jnp.asarray(valid), KEY, JRansacConfig(error_model=model))
        with pytest.raises(ValueError, match="camera"):
            transac.ransac_se3(*_t(p1, p2, w, valid), torch.Generator().manual_seed(0),
                               RansacConfig(error_model=model))


# ---------------------------------------------------------------------------
# the gated matcher
# ---------------------------------------------------------------------------


def _descs(rng, n, m, p_valid=0.9):
    d1 = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, size=(m, 8), dtype=np.uint32)
    k = min(n, m) // 2
    d2[:k] = d1[:k] ^ (rng.integers(0, 2**32, size=(k, 8), dtype=np.uint32)
                       & rng.integers(0, 2**32, size=(k, 8), dtype=np.uint32)
                       & rng.integers(0, 2**32, size=(k, 8), dtype=np.uint32))
    d2[k:k + 4] = d2[:4]                    # exact duplicate trains -> index ties
    return d1, d2, rng.random(n) < p_valid, rng.random(m) < p_valid


def _td(d):
    return torch.from_numpy(np.ascontiguousarray(d).view(np.int32))


def model_gates(best_idx, best_dist, second, col_best, v1, ratio):
    """match_gate_kernel, one query at a time."""
    f = np.float32
    out = np.zeros(len(best_idx), bool)
    for i in range(len(best_idx)):
        j = int(best_idx[i])
        ok = f(best_dist[i]) < f(ratio) * f(second[i])
        out[i] = (ok and int(col_best[j]) == i and bool(v1[i])
                  and int(best_dist[i]) < (1 << 20))
    return out


@pytest.mark.parametrize("n,m,p_valid", [(300, 257, 0.9), (257, 300, 0.6), (64, 64, 0.0)])
def test_gated_matcher_matches_jax(n, m, p_valid):
    """match_gated_ref and the gate kernel's model against the JAX matcher:
    idx2, dist, valid exact, and against the JAX match_frames'
    `valid & obs_valid2[idx2]`: a valid match implies a valid train row, so
    the port needs no separate train-side gate."""
    rng = np.random.default_rng(n + m)
    d1, d2, v1, v2 = _descs(rng, n, m, p_valid)
    j = jmatch.match_descriptors(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2),
                                 jnp.asarray(v2), 0.9)
    j_valid = np.asarray(j.valid)
    np.testing.assert_array_equal(j_valid, j_valid & v2[np.asarray(j.idx2)])
    t = tmatch.match_descriptors(_td(d1), torch.from_numpy(v1), _td(d2),
                                 torch.from_numpy(v2), 0.9)
    np.testing.assert_array_equal(t.idx2.numpy(), np.asarray(j.idx2))
    np.testing.assert_array_equal(t.dist.numpy(), np.asarray(j.dist))
    np.testing.assert_array_equal(t.valid.numpy(), j_valid)
    outs = kernels.hamming_match_2nn_ref(_td(d1), _td(d2), torch.from_numpy(v1),
                                         torch.from_numpy(v2))
    model = model_gates(*(o.numpy() for o in outs), v1, 0.9)
    np.testing.assert_array_equal(model, j_valid)
    assert p_valid == 0.0 or int(j_valid.sum()) > 20


def test_gated_matcher_batched_equals_per_entry():
    rng = np.random.default_rng(11)
    sets = [_descs(rng, 200, 180) for _ in range(5)]
    d2, v2 = sets[0][1], sets[0][3]
    D1 = torch.stack([_td(s[0]) for s in sets])
    V1 = torch.stack([torch.from_numpy(s[2]) for s in sets])
    kernels.reset_launch_counts()
    b = tmatch.match_descriptors(D1, V1, _td(d2), torch.from_numpy(v2), 0.9)
    assert kernels.LAUNCHES["match_gates"] == 0 and kernels.LAUNCHES["hamming_match_2nn"] == 0
    for i in range(5):
        one = tmatch.match_descriptors(D1[i], V1[i], _td(d2), torch.from_numpy(v2), 0.9)
        for name in ("idx2", "dist", "valid"):
            assert torch.equal(getattr(b, name)[i], getattr(one, name))
    with pytest.raises(ValueError):
        kernels.match_gated(D1, _td(d2), V1, torch.from_numpy(v2), 0.9)
