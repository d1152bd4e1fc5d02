"""The SlamConfig fields the port took over from the JAX package in one
slice, on the CPU against rgbdslam_tpu: kNN covariances, reassociating
GICP, GICP without covariances, point-to-plane ICP, RANSAC's error models
and its Mahalanobis polish as the JAX package's own behaviour tests hold
them, the construction checks of the limits that stay on the card, and
whole runs of SlamSystem and PipelinedOdometry in those configurations.

Tolerances, each with its reason:
- kNN covariances: neighbour sets exact on generic data (no two distances
  equal), C within 1e-6 of max|C| (the centred moments summed in another
  order than XLA's);
- GICP poses rtol 1e-4 / atol 1e-5: the bound tests/test_torch_gicp.py holds
  the plain loop to against the JAX loop (f32 sums in other orders over ten
  rounds); converged and the valid count exact;
- point-to-plane ICP: the same bound;
- the behaviour tests: the JAX tests' own bounds;
- whole runs: the bounds of tests/test_torch_system.py (SlamSystem: both
  ATEs < 0.06 m and within 0.02 m of each other, keyframes within 10 %, at
  most 3 failed frames) and tests/test_torch_pipeline.py
  (PipelinedOdometry: < 0.05 m, within 0.01 m, no failed frame): the RANSAC
  draws differ between the packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.config import ExtractorConfig as JExtractorConfig
from rgbdslam_tpu.config import IcpConfig as JIcpConfig
from rgbdslam_tpu.config import LoopConfig as JLoopConfig
from rgbdslam_tpu.config import RansacConfig as JRansacConfig
from rgbdslam_tpu.config import SlamConfig as JSlamConfig
from rgbdslam_tpu.eval.ate import ate_rmse as j_ate
from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.io.synthetic import SyntheticDataset as JSyntheticDataset
from rgbdslam_tpu.slam import pipeline as jpipeline
from rgbdslam_tpu.slam import system as jsystem
from rgbdslam_tpu.solvers import icp as jicp
from rgbdslam_tpu_torch import convert
from rgbdslam_tpu_torch.config import ExtractorConfig, IcpConfig, RansacConfig, SlamConfig
from rgbdslam_tpu_torch.eval.ate import ate_rmse
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC, Camera
from rgbdslam_tpu_torch.ops import kernels
from rgbdslam_tpu_torch.slam.pipeline import PipelinedOdometry
from rgbdslam_tpu_torch.slam.system import SlamSystem
from rgbdslam_tpu_torch.slam.tracking import Tracker, check_system_config
from rgbdslam_tpu_torch.solvers import icp
from rgbdslam_tpu_torch.solvers import ransac_se3 as rs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a).copy()) for a in arrays]


def make_surface(rng, n=256):
    """Points on a bumpy surface (tests/test_pnp_icp.py)."""
    xy = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    z = 2.0 + 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.stack([xy[:, 0], xy[:, 1], z], axis=-1).astype(np.float32)


def make_scene(rng, n=200, noise=0.0, rotvec=(0.05, -0.1, 0.2), t=(0.1, 0.05, -0.2)):
    """Camera-like 3D points and their transform (tests/test_ransac.py)."""
    p1 = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                   rng.uniform(0.5, 4.0, n)], axis=-1).astype(np.float32)
    R = ScipyRot.from_rotvec(rotvec).as_matrix().astype(np.float32)
    p2 = p1 @ R.T + np.asarray(t, np.float32) + rng.normal(scale=noise, size=(n, 3)).astype(
        np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return p1, p2.astype(np.float32), T


def pose_err(Ta, Tb):
    d = np.linalg.inv(Ta) @ Tb
    ang = np.arccos(np.clip(0.5 * (np.trace(d[:3, :3]) - 1.0), -1.0, 1.0))
    return float(np.linalg.norm(d[:3, 3])), float(ang)


# ---------------------------------------------------------------------------
# kNN covariances, GICP, point-to-plane ICP against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p_valid", [1.0, 0.8])
def test_knn_covariances_match_jax(p_valid):
    rng = np.random.default_rng(3)
    pts = make_surface(rng, 300)
    valid = rng.uniform(size=300) < p_valid
    Cj = np.asarray(jicp.knn_covariances(jnp.asarray(pts), jnp.asarray(valid), k=8))
    Ct = icp.knn_covariances(*_t(pts, valid), k=8).numpy()
    # the neighbour sets: JAX's approx_max_k is exact on the CPU
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    d2[~(valid[:, None] & valid[None])] = np.inf
    np.fill_diagonal(d2, np.inf)
    _, idx_j = jax.lax.approx_max_k(-jnp.asarray(d2), 8)
    neg = -torch.from_numpy(d2)
    idx_t = torch.sort(neg, dim=-1, descending=True, stable=True).indices[:, :8]
    fin = np.isfinite(np.take_along_axis(d2, idx_t.numpy(), 1))
    for i in range(300):
        assert set(idx_t[i].numpy()[fin[i]]) == set(np.asarray(idx_j)[i][fin[i]])
    scale = float(np.abs(Cj).max())
    assert float(np.abs(Ct - Cj).max()) <= 1e-6 * scale
    if p_valid < 1.0:                 # an invalid point has no neighbour: the floor alone
        i = int(np.flatnonzero(~valid)[0])
        np.testing.assert_allclose(Ct[i], 1e-3 * 1e-4 / 3.0 * np.eye(3), rtol=1e-6)


def _gicp_problem(seed, n=256, bad=0.0):
    rng = np.random.default_rng(seed)
    p1 = make_surface(rng, n)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = ScipyRot.from_rotvec([0.03, -0.02, 0.01]).as_matrix()
    T[:3, 3] = [0.04, 0.02, -0.03]
    p2 = (p1 @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    if bad:
        idx = rng.choice(n, size=int(bad * n), replace=False)
        p2[idx] = p2[rng.permutation(idx)]
    xi = torch.tensor([0.02, -0.015, 0.01, 0.01, -0.008, 0.006])
    T0 = se3.exp(xi).numpy() @ T
    valid = rng.uniform(size=n) < 0.95
    return p1, p2, valid, T0.astype(np.float32), T


@pytest.mark.parametrize("reassociate", [False, True])
@pytest.mark.parametrize("given_cov", [False, True])
def test_gicp_variants_match_jax(reassociate, given_cov):
    """gicp_refine with and without reassociation, with covariances given or
    computed from each set's neighbours, against the JAX package's XLA
    loop."""
    p1, p2, valid, T0, _ = _gicp_problem(21, bad=0.2 if reassociate else 0.0)
    kw = dict(max_iterations=12, max_correspondence_dist=0.2, reassociate=reassociate)
    C1 = C2 = None
    if given_cov:
        C1 = np.asarray(jicp.knn_covariances(jnp.asarray(p1), jnp.asarray(valid)))
        C2 = np.asarray(jicp.knn_covariances(jnp.asarray(p2), jnp.asarray(valid)))
    Tj, cj, nj = jicp.gicp_refine(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                                  jnp.asarray(T0), None, JIcpConfig(**kw),
                                  None if C1 is None else jnp.asarray(C1),
                                  None if C2 is None else jnp.asarray(C2))
    kernels.reset_launch_counts()
    Tt, ct, nt = icp.gicp_refine(*_t(p1, p2, valid, T0), IcpConfig(**kw),
                                 *(_t(C1, C2) if given_cov else (None, None)))
    assert kernels.LAUNCHES["gicp_refine_fused"] == 0
    assert bool(ct) == bool(cj) and int(nt) == int(nj)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-4, atol=1e-5)


def test_nearest_targets_first_index_on_ties():
    q = torch.tensor([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]])
    p2 = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [9.0, 9.0, 9.0], [1.0, 0.0, 0.0]])
    valid = torch.tensor([False, True, True, True])
    assert icp.nearest_targets(q, p2, valid).tolist() == [1, 2]
    assert icp.nearest_targets(q, p2, torch.zeros(4, dtype=torch.bool)).tolist() == [0, 0]


def test_point_to_plane_icp_matches_jax():
    rng = np.random.default_rng(6)
    src = make_surface(rng, 512)
    normals = np.stack([-0.6 * np.cos(2 * src[:, 0]), 0.6 * np.sin(3 * src[:, 1]),
                        np.ones(512)], axis=-1)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = ScipyRot.from_rotvec([0.01, 0.02, -0.015]).as_matrix()
    T[:3, 3] = [0.02, -0.03, 0.01]
    dst = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    dst[:20, 2] = 0.0                                     # invalid destinations
    n2 = (normals @ T[:3, :3].T).astype(np.float32)
    Tj = np.asarray(jicp.point_to_plane_icp(jnp.asarray(src), jnp.asarray(dst),
                                            jnp.asarray(n2), jnp.eye(4), iters=10))
    Tt = icp.point_to_plane_icp(*_t(src, dst, n2), torch.eye(4), iters=10).numpy()
    np.testing.assert_allclose(Tt, Tj, rtol=1e-4, atol=1e-5)
    tn, rn = pose_err(Tt, T)
    assert tn < 5e-3 and rn < 5e-3, (tn, rn)


# ---------------------------------------------------------------------------
# the JAX package's behaviour tests, on the port
# ---------------------------------------------------------------------------


def test_error_model_variants():
    """tests/test_ransac.py::test_error_model_variants on the port: every
    PUT-style error model recovers the transform on outlier-contaminated
    data (rotation < 1 degree, translation < 5 cm)."""
    rng = np.random.default_rng(7)
    n = 128
    p1, p2, T = make_scene(rng, n=n, noise=0.002)
    out_idx = rng.choice(n, 40, replace=False)
    p2c = p2.copy()
    p2c[out_idx] += rng.normal(scale=1.0, size=(40, 3)).astype(np.float32)
    w = np.ones(n, dtype=np.float32)
    valid = np.ones(n, bool)
    for model in ["euclidean", "adaptive_euclidean", "reprojection", "both"]:
        res = rs.ransac_se3(*_t(p1, p2c, w, valid), torch.Generator().manual_seed(10),
                            RansacConfig(error_model=model), cam=SYNTHETIC)
        assert bool(res.success), model
        T_est = res.T21.numpy()
        dR = T_est[:3, :3].T @ T[:3, :3]
        ang = np.degrees(np.arccos(np.clip(0.5 * (np.trace(dR) - 1), -1, 1)))
        assert ang < 1.0, (model, ang)
        assert np.linalg.norm(T_est[:3, 3] - T[:3, 3]) < 0.05, model


def test_mahalanobis_refine_beats_scalar_fit_under_depth_noise():
    """tests/test_ransac.py's test of the same name on the port: with
    z^2-scaled depth noise at 2.5-4 m the whitened polish recovers a better
    transform than the scalar-weighted fit alone."""
    rng = np.random.default_rng(11)
    n = 512
    p1, p2, T = make_scene(rng, n=n, noise=0.0, rotvec=(0.03, -0.05, 0.02),
                           t=(0.1, -0.05, 0.08))
    p1[:, 2] += 1.5
    p2 = p1 @ T[:3, :3].T + T[:3, 3]
    for p in (p1, p2):
        p[:, 2] += rng.normal(size=n) * 0.01 * p[:, 2] ** 2
        p[:, :2] += rng.normal(size=(n, 2)) * 0.002
    w = (1.0 / (np.maximum(p1[:, 2], 0.1) * np.maximum(p2[:, 2], 0.1))).astype(np.float32)
    args = _t(p1.astype(np.float32), p2.astype(np.float32), w, np.ones(n, bool))

    def run(cfg, seed):
        res = rs.ransac_se3(*args, torch.Generator().manual_seed(seed), cfg)
        return pose_err(res.T21.numpy(), T)[0]

    plain = [run(RansacConfig(), s) for s in range(3)]
    aniso = [run(RansacConfig(mahalanobis_refine=True), s) for s in range(3)]
    assert np.mean(aniso) < np.mean(plain), (aniso, plain)


def test_knn_covariances_planar():
    """tests/test_pnp_icp.py's test of the same name: symmetric, positive
    definite."""
    pts = make_surface(np.random.default_rng(5), 128)
    C = icp.knn_covariances(*_t(pts, np.ones(128, bool)), k=8).numpy()
    assert C.shape == (128, 3, 3)
    np.testing.assert_allclose(C, np.swapaxes(C, 1, 2), atol=1e-6)
    assert np.linalg.eigvalsh(C).min() > 0


def test_point_to_plane_icp():
    """tests/test_pnp_icp.py's test of the same name: the exact transform
    within 5 mm / 5 mrad in ten rounds."""
    rng = np.random.default_rng(6)
    src = make_surface(rng, 512)
    normals = np.stack([-0.6 * np.cos(2 * src[:, 0]), 0.6 * np.sin(3 * src[:, 1]),
                        np.ones(512)], axis=-1)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = ScipyRot.from_rotvec([0.01, 0.02, -0.015]).as_matrix()
    T[:3, 3] = [0.02, -0.03, 0.01]
    dst = src @ T[:3, :3].T + T[:3, 3]
    dst_normals = (normals @ T[:3, :3].T).astype(np.float32)
    T_est = icp.point_to_plane_icp(*_t(src, dst.astype(np.float32), dst_normals),
                                   torch.eye(4), iters=10)
    tn, rn = pose_err(T_est.numpy(), T)
    assert tn < 5e-3 and rn < 5e-3, (tn, rn)


def test_gicp_accepts_precomputed_covariances():
    rng = np.random.default_rng(7)
    p1 = make_surface(rng)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.02, -0.01, 0.03]
    p2 = (p1 @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    valid = torch.ones(len(p1), dtype=torch.bool)
    tp1, tp2 = _t(p1, p2)
    C1, C2 = icp.knn_covariances(tp1, valid), icp.knn_covariances(tp2, valid)
    cfg = IcpConfig(max_iterations=8, max_correspondence_dist=0.2)
    T_ref, conv, _ = icp.gicp_refine(tp1, tp2, valid, torch.eye(4), cfg, C1, C2)
    assert bool(conv)
    assert pose_err(T_ref.numpy(), T)[0] < 5e-3


def test_gicp_reassociation_recovers_from_bad_pairings():
    """tests/test_pnp_icp.py's test of the same name: with 30 % of the
    pairings shuffled, fixed-pair GN is pulled off while reassociate=True
    recovers the transform."""
    rng = np.random.default_rng(11)
    p1 = make_surface(rng, n=256)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = ScipyRot.from_rotvec([0.03, -0.02, 0.01]).as_matrix()
    T[:3, 3] = [0.04, 0.02, -0.03]
    p2 = (p1 @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    n = len(p1)
    bad = rng.choice(n, size=int(0.3 * n), replace=False)
    p2_bad = p2.copy()
    p2_bad[bad] = p2[rng.permutation(bad)]
    T0 = se3.exp(torch.tensor([0.02, -0.015, 0.01, 0.01, -0.008, 0.006])) @ torch.from_numpy(T)
    valid = torch.ones(n, dtype=torch.bool)
    args = _t(p1, p2_bad)
    T_fix, _, _ = icp.gicp_refine(*args, valid, T0,
                                  IcpConfig(max_iterations=12, max_correspondence_dist=0.2))
    T_re, conv_re, _ = icp.gicp_refine(*args, valid, T0, IcpConfig(
        max_iterations=12, max_correspondence_dist=0.2, reassociate=True))
    assert bool(conv_re)
    tn_fix, _ = pose_err(T_fix.numpy(), T)
    tn_re, rn_re = pose_err(T_re.numpy(), T)
    assert tn_re < 0.01 and rn_re < 0.01, (tn_re, rn_re)
    assert tn_re < tn_fix * 0.7, (tn_re, tn_fix)


# ---------------------------------------------------------------------------
# what the card's check accepts (every detection) and refuses (the camera
# models), at construction
# ---------------------------------------------------------------------------


def test_check_card_config_refuses_the_limits_and_nothing_else():
    """`check_system_config` for the card refuses only what the JAX package
    refuses: every cell of 1 to 64 pixels (cells of 1 and 2: 307,200 and
    76,800 cells a level at 640x480), 4 to 16 levels of the x1.2 scale space
    and of the half-sample pyramid, every detector, pass; a reprojection
    error model without a camera does not."""
    cam = SYNTHETIC                                         # 640 x 480

    def card_check(cfg, cam):
        check_system_config(cfg, cam, torch.device("cuda"))

    for cell in range(1, 65):
        cfg = SlamConfig(extractor=ExtractorConfig(cell_size=cell))
        card_check(cfg, cam)
        card_check(dataclasses.replace(cfg, detector="orb"), cam)
        card_check(dataclasses.replace(cfg, detector="star"), cam)
    for levels in range(4, 17):
        card_check(SlamConfig(extractor=ExtractorConfig(num_levels=levels, scale_factor=1.2)),
                   cam)
        card_check(SlamConfig(extractor=ExtractorConfig(num_levels=levels)), cam)
        card_check(SlamConfig(detector="orb", extractor=ExtractorConfig(
            num_levels=levels, scale_factor=1.2, cell_size=40)), cam)
    card_check(SlamConfig(detector="orb"), cam)
    for model in ("reprojection", "both"):
        with pytest.raises(ValueError, match="camera"):
            card_check(SlamConfig(ransac=RansacConfig(error_model=model)), cam)


def test_constructors_refuse_on_the_card_only_and_the_camera_models_everywhere():
    """Tracker, SlamSystem and PipelinedOdometry run the check for the card
    (a CUDA request without one raises first here); on the CPU a cell of 40
    is built; a reprojection model raises ValueError on either device, as
    the JAX SlamSystem raises at its first frame."""
    wide = SlamConfig(extractor=ExtractorConfig(cell_size=40))
    for cls in (Tracker, SlamSystem, PipelinedOdometry):
        cls(SYNTHETIC, wide, device="cpu")
        with pytest.raises(ValueError, match="camera"):
            cls(SYNTHETIC, SlamConfig(ransac=RansacConfig(error_model="reprojection")),
                device="cpu")


# ---------------------------------------------------------------------------
# whole runs in the new configurations against the JAX package
# ---------------------------------------------------------------------------


CAM_ARGS = dict(fx=200.0, fy=200.0, cx=159.5, cy=119.5, width=320, height=240)
N_FRAMES = 100


@pytest.fixture(scope="module")
def orbit():
    """tests/test_torch_system.py's 100 orbit frames (320x240, loops=1.15)
    rendered once by the JAX package."""
    ds = JSyntheticDataset(n_frames=N_FRAMES, cam=JCamera(**CAM_ARGS), trajectory="orbit",
                           loops=1.15)
    frames = []
    for i in range(N_FRAMES):
        ts, g, d = ds.grab(i)
        frames.append((float(ts), np.asarray(g), np.asarray(d)))
    return ds, frames


def _jcfg(**ransac_icp):
    ex = JExtractorConfig(num_features=1024, num_levels=3, cell_size=6, fast_threshold=15.0)
    return JSlamConfig(extractor=ex, loop=JLoopConfig(id_interval=12, min_kfs_since_loop=10),
                       **ransac_icp)


def test_slam_system_new_configuration_matches_jax(orbit):
    """SlamSystem at cell 6, RANSAC of 3 samples, the Euclidean error model
    with the Mahalanobis polish, reassociating GICP, on the same frames in
    both packages."""
    ds, frames = orbit
    jcfg = _jcfg(ransac=JRansacConfig(sample_size=3, error_model="euclidean",
                                      mahalanobis_refine=True),
                 icp=JIcpConfig(reassociate=True))
    sj = jsystem.SlamSystem(JCamera(**CAM_ARGS), jcfg, seed=0)
    st = SlamSystem(Camera(**CAM_ARGS), convert.config_from_jax(jcfg), seed=0, device="cpu")
    for s in (sj, st):
        for f in frames:
            s.track(*f)
        s.finish()
    ts_t, poses_t = st.camera_trajectory()
    ts_j, poses_j = sj.camera_trajectory()
    rt, info = ate_rmse(ts_t, poses_t, ds.timestamps, ds.poses_twc)
    rj, _ = j_ate(ts_j, poses_j, ds.timestamps, ds.poses_twc)
    assert info["pairs"] == N_FRAMES and np.isfinite(poses_t).all()
    assert rt < 0.06 and rj < 0.06, (rt, rj)
    assert abs(rt - rj) < 0.02, (rt, rj)
    assert abs(st.store.count - sj.store.count) <= max(1, 0.1 * sj.store.count)
    assert st.tracker.stats.failures <= 3


@pytest.fixture(scope="module")
def sweep():
    """tests/test_torch_pipeline.py's 24-frame 320x240 sweep, rendered once
    by the JAX package."""
    ds = JSyntheticDataset(n_frames=24, cam=JCamera(**CAM_ARGS), trajectory="sweep")
    return ds, [(ts, np.asarray(g), np.asarray(d)) for ts, g, d in
                (ds.grab(i) for i in range(len(ds)))]


@pytest.mark.parametrize("config", ["mahalanobis S5 polish", "euclidean reassociate"])
def test_pipelined_odometry_new_configurations_match_jax(sweep, config):
    """PipelinedOdometry (batches of 8) at cell 6 with RANSAC of 5 samples
    and the polish, and with the Euclidean model and reassociating GICP,
    against the JAX package's pipeline on the same frames, at
    tests/test_torch_pipeline.py's bounds: both ATEs < 0.05 m and within
    0.01 m of each other, no failed frame."""
    ds, frames = sweep
    if config == "euclidean reassociate":
        kw = dict(ransac=JRansacConfig(error_model="euclidean"),
                  icp=JIcpConfig(reassociate=True))
    else:
        kw = dict(ransac=JRansacConfig(sample_size=5, mahalanobis_refine=True))
    jcfg = _jcfg(**kw)
    ts_j, poses_j, stats_j = jpipeline.PipelinedOdometry(JCamera(**CAM_ARGS), jcfg,
                                                         seed=0).run(frames)
    ts_t, poses_t, stats_t = PipelinedOdometry(Camera(**CAM_ARGS),
                                               convert.config_from_jax(jcfg), seed=0,
                                               device="cpu").run(frames)
    rt, _ = ate_rmse(ts_t, poses_t, ds.timestamps, ds.poses_twc)
    rj, _ = j_ate(ts_j, poses_j, ds.timestamps, ds.poses_twc)
    assert np.isfinite(poses_t).all() and len(poses_t) == len(frames)
    assert rt < 0.05 and rj < 0.05, (rt, rj)
    assert abs(rt - rj) < 0.01, (rt, rj)
    assert stats_t["failures"] == stats_j["failures"] == 0
