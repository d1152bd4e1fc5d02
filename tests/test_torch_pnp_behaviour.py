"""The JAX suite's PnP behaviour tests (tests/test_pnp_icp.py :45-100 and
:277-514, the cv2 oracles included) on the port alone, with no JAX re-run:
the draws come from the port's generator, and every test keeps the JAX
test's own bounds. The parity of the PnP family with the JAX package is
tests/test_torch_pnp.py.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from rgbdslam_tpu_torch.solvers import pnp as tpnp
from test_torch_pnp import (CAM, T, _exp, _gen, _normalized, _outlier_scene, make_pnp_scene,
                            pose_err)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_motion_only_ba_converges():
    rng = np.random.default_rng(0)
    Xw, uv, Tcw = make_pnp_scene(rng, noise_px=0.3)
    T0 = _exp([0.05, -0.04, 0.06, 0.02, -0.03, 0.01]) @ Tcw
    T_opt, inl = tpnp.motion_only_ba(CAM, T(T0), T(Xw), T(uv), torch.ones(len(Xw),
                                                                        dtype=torch.bool))
    tn, rn = pose_err(T_opt.numpy(), Tcw)
    assert tn < 5e-3 and rn < 5e-3, (tn, rn)
    assert int(inl.sum()) > 90


def test_motion_only_ba_demotes_outliers():
    rng = np.random.default_rng(1)
    Xw, uv, Tcw = make_pnp_scene(rng, noise_px=0.2)
    uv_c = uv.copy()
    uv_c[:15] += 40.0
    T0 = _exp([0.02, 0.02, -0.02, 0.01, 0.01, -0.01]) @ Tcw
    T_opt, inl = tpnp.motion_only_ba(CAM, T(T0), T(Xw), T(uv_c),
                                     torch.ones(len(Xw), dtype=torch.bool))
    assert int(inl[:15].sum()) == 0
    tn, rn = pose_err(T_opt.numpy(), Tcw)
    assert tn < 0.01 and rn < 0.01


def test_pnp_ransac_with_outliers():
    Xw, uv_c, Tcw = _outlier_scene(2)
    res = tpnp.pnp_ransac(CAM, T(Xw), T(uv_c), torch.ones(200, dtype=torch.bool), _gen(0))
    assert bool(res.success)
    tn, rn = pose_err(res.Tcw.numpy(), Tcw)
    assert tn < 0.02 and rn < 0.01, (tn, rn)
    assert int(res.num_inliers) > 100


def test_reproj_residual_zero_at_truth():
    Xw, uv, Tcw = make_pnp_scene(np.random.default_rng(3))
    r = tpnp.reproj_residuals(CAM, T(Tcw), T(Xw), T(uv)).numpy()
    assert np.abs(r).max() < 1e-2


def test_p3p_matches_cv2_oracle():
    """On exact 3-point data one of the (<= 4) Grunert solutions is the
    ground truth, and every cv2.solveP3P solution has a match among ours."""
    import cv2

    rng = np.random.default_rng(3)
    Kmat = np.array([[CAM.fx, 0, CAM.cx], [0, CAM.fy, CAM.cy], [0, 0, 1]])
    checked = 0
    for trial in range(12):
        Xw = np.stack([rng.uniform(-2, 2, 3), rng.uniform(-1.5, 1.5, 3),
                       rng.uniform(2, 6, 3)], -1).astype(np.float32)
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = ScipyRot.from_rotvec(rng.normal(0, 0.3, 3)).as_matrix()
        Tcw[:3, 3] = rng.normal(0, 0.5, 3)
        Xc = Xw @ Tcw[:3, :3].T + Tcw[:3, 3]
        if (Xc[:, 2] < 0.2).any():
            continue
        rays = (Xc / np.linalg.norm(Xc, axis=1, keepdims=True)).astype(np.float32)
        T4, ok = tpnp._p3p_grunert(T(rays), T(Xw))
        T4, ok = T4.numpy(), ok.numpy()
        sols = [T4[i] for i in range(4) if ok[i]]
        assert sols, "no valid P3P solution on exact data"
        errs = [np.linalg.norm((np.linalg.inv(Ts) @ Tcw)[:3, 3]) for Ts in sols]
        assert min(errs) < 2e-3, f"trial {trial}: best {min(errs):.4f}"
        uv = np.stack([CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx,
                       CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy], -1)
        _, rvecs, tvecs = cv2.solveP3P(Xw.astype(np.float64), uv.astype(np.float64), Kmat,
                                       None, flags=cv2.SOLVEPNP_P3P)
        for r_, t_ in zip(rvecs, tvecs):
            Tref = np.eye(4)
            Tref[:3, :3] = cv2.Rodrigues(r_)[0]
            Tref[:3, 3] = t_.ravel()
            d = min(np.linalg.norm((np.linalg.inv(Ts) @ Tref)[:3, 3]) for Ts in sols)
            assert d < 0.08, f"cv2 solution not found by Grunert ({d:.4f})"
        checked += 1
    assert checked >= 8


def test_p3p_ransac_succeeds_where_dlt6_fails():
    """At a 70 % outlier rate the 3-point sampler recovers the pose while
    the 6-point DLT sampler fails (per-draw all-inlier probability 0.3^3 =
    2.7e-2 against 0.3^6 = 7.3e-4)."""
    p3p_good = dlt_good = 0
    for seed in range(3):
        Xw, uv_c, Tcw = _outlier_scene(seed, n_out=140)
        for minimal in ("p3p", "dlt6"):
            res = tpnp.pnp_ransac(CAM, T(Xw), T(uv_c), torch.ones(200, dtype=torch.bool),
                                  _gen(seed), minimal)
            terr = np.linalg.norm((np.linalg.inv(res.Tcw.numpy()) @ Tcw)[:3, 3])
            good = bool(res.success) and terr < 0.02
            if minimal == "p3p":
                p3p_good += good
            else:
                dlt_good += good
    assert p3p_good == 3, f"p3p {p3p_good}/3"
    assert dlt_good < p3p_good, "DLT-6 should fail where P3P succeeds"


def test_pnp_ransac_p3p_default_clean():
    rng = np.random.default_rng(5)
    Xw, uv, Tcw = make_pnp_scene(rng, n=200, noise_px=0.3)
    res = tpnp.pnp_ransac(CAM, T(Xw), T(uv), torch.ones(200, dtype=torch.bool), _gen(1))
    assert bool(res.success)
    tn, rn = pose_err(res.Tcw.numpy(), Tcw)
    assert tn < 0.01 and rn < 0.01, (tn, rn)


def test_p3p_degenerate_inputs_do_not_poison():
    """Collinear or coincident samples give finite poses, and the RANSAC
    still succeeds when such samples occur among valid data."""
    Xw = np.array([[0.0, 0.0, 2.0], [0.1, 0.0, 2.0], [0.2, 0.0, 2.0]], np.float32)
    rays = Xw / np.linalg.norm(Xw, axis=1, keepdims=True)
    T4, _ = tpnp._p3p_grunert(T(rays.astype(np.float32)), T(Xw))
    assert np.isfinite(T4.numpy()).all()
    Xw2 = np.tile(np.array([0.3, -0.1, 1.5], np.float32), (3, 1))
    rays2 = Xw2 / np.linalg.norm(Xw2, axis=1, keepdims=True)
    T4b, _ = tpnp._p3p_grunert(T(rays2), T(Xw2))
    assert np.isfinite(T4b.numpy()).all()
    rng = np.random.default_rng(7)
    Xw3, uv3, Tcw = make_pnp_scene(rng, n=64, noise_px=0.2)
    Xw3[32:] = Xw3[:32]
    uv3[32:] = uv3[:32]
    res = tpnp.pnp_ransac(CAM, T(Xw3), T(uv3), torch.ones(64, dtype=torch.bool), _gen(2))
    assert bool(res.success)
    tn, rn = pose_err(res.Tcw.numpy(), Tcw)
    assert tn < 0.02 and rn < 0.02


def _epnp_on(Xw, uv, w=None):
    if w is None:
        w = np.ones(len(Xw), np.float32)
    return tpnp._epnp_pose(T(Xw), T(_normalized(uv)), T(w)).numpy()


def test_epnp_matches_cv2_oracle():
    import cv2

    rng = np.random.default_rng(11)
    K = np.array([[CAM.fx, 0, CAM.cx], [0, CAM.fy, CAM.cy], [0, 0, 1]], np.float64)
    for trial in range(5):
        Xw, uv, Tcw = make_pnp_scene(rng, n=24, noise_px=0.0)
        Te = _epnp_on(Xw, uv)
        tn, rn = pose_err(Te, Tcw)
        assert tn < 5e-3 and rn < 5e-3, (trial, tn, rn)
        ok, rvec, tvec = cv2.solvePnP(Xw.astype(np.float64), uv.astype(np.float64), K, None,
                                      flags=cv2.SOLVEPNP_EPNP)
        assert ok
        Tcv = np.eye(4, dtype=np.float32)
        Tcv[:3, :3] = cv2.Rodrigues(rvec)[0]
        Tcv[:3, 3] = tvec[:, 0]
        tn, rn = pose_err(Te, Tcv)
        assert tn < 1e-2 and rn < 1e-2, (trial, tn, rn)


def test_epnp_weighted_ignores_outliers():
    rng = np.random.default_rng(12)
    Xw, uv, Tcw = make_pnp_scene(rng, n=40, noise_px=0.0)
    uv_c = uv.copy()
    uv_c[:10] += 80.0
    w = np.ones(40, np.float32)
    w[:10] = 0.0
    tn, rn = pose_err(_epnp_on(Xw, uv_c, w), Tcw)
    assert tn < 5e-3 and rn < 5e-3, (tn, rn)


def test_pnp_ransac_epnp_minimal_and_refit():
    Xw, uv_c, Tcw = _outlier_scene(13, n_out=80)
    for minimal, refit in (("epnp", "ba"), ("p3p", "epnp+ba")):
        res = tpnp.pnp_ransac(CAM, T(Xw), T(uv_c), torch.ones(200, dtype=torch.bool),
                              _gen(0), minimal=minimal, refit=refit)
        assert bool(res.success), (minimal, refit)
        tn, rn = pose_err(res.Tcw.numpy(), Tcw)
        assert tn < 0.02 and rn < 0.01, (minimal, refit, tn, rn)
        assert int(res.num_inliers) > 100


def test_pnp_minimal_ab_outlier_sweep():
    """The minimal solvers across outlier rates: every solver is reliable
    through 50 % outliers, and P3P still succeeds at 70 %."""
    by_rate = {}
    for rate in (0.0, 0.3, 0.5, 0.7):
        succ = {"p3p": 0, "epnp": 0, "dlt6": 0}
        for t in range(3):
            rng = np.random.default_rng(100 + t)
            n = 200
            Xw, uv, Tcw = make_pnp_scene(rng, n=n, noise_px=0.3)
            uv_c = uv.copy()
            k = int(rate * n)
            if k:
                oi = rng.choice(n, k, replace=False)
                uv_c[oi] = rng.uniform([0, 0], [640, 480], size=(k, 2))
            for m in succ:
                res = tpnp.pnp_ransac(CAM, T(Xw), T(uv_c), torch.ones(n, dtype=torch.bool),
                                      _gen(t), minimal=m)
                tn, _ = pose_err(res.Tcw.numpy(), Tcw)
                succ[m] += bool(res.success) and tn < 0.05
        by_rate[rate] = {m: succ[m] / 3 for m in succ}
    for r in (0.0, 0.3, 0.5):
        assert by_rate[r]["p3p"] == 1.0, by_rate
        assert by_rate[r]["epnp"] == 1.0, by_rate
    assert by_rate[0.7]["p3p"] == 1.0, by_rate


def test_pnp_refusals():
    Xw, uv, _ = make_pnp_scene(np.random.default_rng(0), n=16)
    v = torch.ones(16, dtype=torch.bool)
    with pytest.raises(ValueError, match="generator"):
        tpnp.pnp_ransac(CAM, T(Xw), T(uv), v)
    with pytest.raises(ValueError, match="minimal"):
        tpnp.pnp_ransac(CAM, T(Xw), T(uv), v, _gen(0), minimal="p4p")
