"""Dense projective ICP and the Kinect-class sensor noise of
rgbdslam_tpu_torch against rgbdslam_tpu on the same arrays: depth
backprojection, depth normals, `dense_icp` (from the identity and from a
perturbed start, with both of its gates) and `apply_sensor_noise` fed JAX's
own draws.

Tolerances: points and normals within 1e-6 and the normal mask exact (the
port multiplies by the focal length's f32 reciprocal, as the compiled JAX
function does); dense_icp poses within 1e-5 (twenty Gauss-Newton rounds
whose sums run in another order); the noise within one f32 rounding of the
values (2e-5 on grey levels up to 255, 1e-6 on depths) and the dropout mask
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.geometry import se3 as jse3
from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.geometry.camera import depth_to_points as j_depth_to_points
from rgbdslam_tpu.io.synthetic import SyntheticDataset as JSyntheticDataset
from rgbdslam_tpu.io.synthetic import apply_sensor_noise as j_noise
from rgbdslam_tpu.solvers import dense_icp as jdense
from rgbdslam_tpu_torch.geometry import se3
from rgbdslam_tpu_torch.geometry.camera import Camera, depth_to_points
from rgbdslam_tpu_torch.io.synthetic import (SyntheticDataset, apply_sensor_noise,
                                             kinect_noise_fields)
from rgbdslam_tpu_torch.solvers import dense_icp as tdense
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# tests/test_dense_icp.py's camera
CAM_ARGS = dict(fx=160.0, fy=160.0, cx=127.5, cy=95.5, width=256, height=192)
JCAM, TCAM = JCamera(**CAM_ARGS), Camera(**CAM_ARGS)
PERTURB = np.r_[0.02, -0.02, 0.02, 0.01, -0.01, 0.01].astype(np.float32)


@pytest.fixture(scope="module")
def sweep():
    """tests/test_dense_icp.py's 40-frame sweep: depth maps of frames 0-6 and
    the ground-truth poses, rendered once by the JAX package."""
    ds = JSyntheticDataset(n_frames=40, cam=JCAM, trajectory="sweep")
    return ds.poses_twc, [np.asarray(ds.grab(i)[2]) for i in range(7)]


def _t(a):
    return torch.from_numpy(np.array(a))


def test_depth_to_points_and_normals_match_jax(sweep):
    _poses, depths = sweep
    j_points = jax.jit(j_depth_to_points, static_argnums=0)
    j_normals = jax.jit(jdense.depth_normals, static_argnums=0)
    for d in (depths[1], depths[4], np.full((64, 64), 2.0, np.float32)):
        np.testing.assert_allclose(depth_to_points(TCAM, _t(d)).numpy(),
                                   np.asarray(j_points(JCAM, jnp.asarray(d))), rtol=0, atol=1e-6)
        pj, nj = (np.asarray(a) for a in j_normals(JCAM, jnp.asarray(d)))
        pt, nt = (a.numpy() for a in tdense.depth_normals(TCAM, _t(d)))
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
        np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(np.any(nt != 0, axis=-1), np.any(nj != 0, axis=-1))
    # a flat wall straight ahead: normals along -z, toward the camera
    _, n = tdense.depth_normals(Camera(64.0, 64.0, 31.5, 31.5, width=64, height=64),
                                torch.full((64, 64), 2.0))
    assert torch.all(n[10:-10, 10:-10, 2] < -0.95)


def test_scaled_camera_and_pose_norms_match_jax():
    for s in (2, 4):
        cj, ct = jdense.scaled_camera(JCAM, s), tdense.scaled_camera(TCAM, s)
        assert (ct.fx, ct.fy, ct.cx, ct.cy, ct.width, ct.height) == (
            cj.fx, cj.fy, cj.cx, cj.cy, cj.width, cj.height)
    rng = np.random.default_rng(0)
    xi = rng.normal(scale=[0.5] * 3 + [1.0] * 3, size=(16, 6)).astype(np.float32)
    T = np.array(jse3.exp(jnp.asarray(xi)))
    T[0] = np.eye(4, dtype=np.float32)
    np.testing.assert_allclose(se3.translation_norm(_t(T)).numpy(),
                               np.asarray(jse3.translation_norm(jnp.asarray(T))), atol=1e-6)
    np.testing.assert_allclose(se3.rotation_angle(_t(T)).numpy(),
                               np.asarray(jse3.rotation_angle(jnp.asarray(T))), atol=1e-6)


@pytest.mark.parametrize("pair", [(0, 1), (0, 2), (5, 6)])
@pytest.mark.parametrize("start", ["identity", "perturbed"])
def test_dense_icp_matches_jax(sweep, pair, start):
    """The same depth pair and start through both packages: the poses agree
    within 1e-5; from the perturbed start both come closer to the truth
    (tests/test_dense_icp.py's checks). From the identity the pairs two
    frames apart move more than the default 0.5 m trust bound: both give the
    identity back."""
    poses, depths = sweep
    i, j = pair
    T21_gt = (np.linalg.inv(poses[j]) @ poses[i]).astype(np.float32)
    T0 = np.eye(4, dtype=np.float32)
    if start == "perturbed":
        T0 = (np.asarray(jse3.exp(jnp.asarray(PERTURB))) @ T21_gt).astype(np.float32)
    Tj = np.asarray(jdense.dense_icp(JCAM, jnp.asarray(depths[i]), jnp.asarray(depths[j]),
                                     jnp.asarray(T0)))
    Tt = tdense.dense_icp(TCAM, _t(depths[i]), _t(depths[j]), _t(T0)).numpy()
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-5)

    def err(T):
        return float(np.linalg.norm((np.linalg.inv(T) @ T21_gt)[:3, 3]))

    if start == "perturbed":
        assert err(Tt) < err(T0) and err(Tj) < err(T0)
    elif pair == (0, 1):
        assert err(Tt) < 0.05          # test_dense_icp_recovers_interframe_motion


def test_dense_icp_gates_return_the_start(sweep):
    """Both gates, decided on the device, hand back T_init exactly as the
    JAX package does: a correction beyond `max_correction`, and a
    non-finite solve (one infinite reference depth makes the normal
    equations NaN at its zero-weighted row)."""
    poses, depths = sweep
    T21_gt = (np.linalg.inv(poses[2]) @ poses[0]).astype(np.float32)
    T0 = (np.asarray(jse3.exp(jnp.asarray(PERTURB))) @ T21_gt).astype(np.float32)
    d0, d2 = depths[0], depths[2]
    # the over-correction gate: the solve moves ~2 cm, the bound is 1e-4
    moved = tdense.dense_icp(TCAM, _t(d0), _t(d2), _t(T0)).numpy()
    assert np.abs(moved - T0).max() > 1e-3
    tight = dict(max_correction=(1e-4, 1e-4))
    Tt = tdense.dense_icp(TCAM, _t(d0), _t(d2), _t(T0), **tight).numpy()
    Tj = np.asarray(jdense.dense_icp(JCAM, jnp.asarray(d0), jnp.asarray(d2), jnp.asarray(T0),
                                     (4, 2), 10, 0.3, (1e-4, 1e-4)))
    np.testing.assert_array_equal(Tt, T0)
    np.testing.assert_array_equal(Tj, T0)
    # the non-finite gate
    bad = d0.copy()
    bad[40, 40] = np.inf
    raw = tdense._icp_level(tdense.scaled_camera(TCAM, 4), _t(bad)[::4, ::4], _t(d2)[::4, ::4],
                            _t(T0), 10, 0.3)
    assert not torch.isfinite(raw).all()
    Tt = tdense.dense_icp(TCAM, _t(bad), _t(d2), _t(T0)).numpy()
    Tj = np.asarray(jdense.dense_icp(JCAM, jnp.asarray(bad), jnp.asarray(d2), jnp.asarray(T0)))
    np.testing.assert_array_equal(Tt, T0)
    np.testing.assert_array_equal(Tj, T0)


def test_sensor_noise_matches_jax_with_injected_draws(sweep):
    """apply_sensor_noise fed JAX's own normal and uniform fields (the
    jax.random.split(key, 3) of the JAX function) gives JAX's noisy frame."""
    ds = JSyntheticDataset(n_frames=4, cam=JCAM, trajectory="tour")
    _, g, d = ds.grab(1)
    g, d = np.array(g), np.array(d)
    d[:5, :7] = 0.0                                 # pixels without depth stay 0
    for seed in (0, 7):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
        gj, dj = (np.asarray(a) for a in j_noise(JCAM, jnp.asarray(g), jnp.asarray(d), key))
        k1, k2, k3 = jax.random.split(key, 3)
        fields = (np.asarray(jax.random.normal(k1, g.shape)),
                  np.asarray(jax.random.normal(k2, d.shape)),
                  np.asarray(jax.random.uniform(k3, d.shape)))
        gt, dt = (a.numpy() for a in apply_sensor_noise(TCAM, _t(g), _t(d), None, *fields))
        np.testing.assert_array_equal(dt == 0, dj == 0)
        assert 0.02 < float(np.mean((dj == 0) & (d > 0))) < 0.04
        np.testing.assert_allclose(gt, gj, rtol=0, atol=2e-5)
        np.testing.assert_allclose(dt, dj, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="three"):
        apply_sensor_noise(TCAM, _t(g), _t(d), None, fields[0], None, None)


def test_noisy_dataset_is_deterministic_per_frame():
    """SyntheticDataset(noise=True) draws each frame's noise from a generator
    seeded by (seed, i): the same frame twice is the same noisy frame, other
    frames and seeds differ; the host fields replay through the same
    function."""
    kw = dict(n_frames=8, cam=Camera(40.0, 40.0, 31.5, 23.5, width=64, height=48),
              trajectory="tour", loops=1.15, device="cpu")
    clean = SyntheticDataset(**kw)
    a, b = SyntheticDataset(noise=True, seed=3, **kw), SyntheticDataset(noise=True, seed=4, **kw)
    _, g1, d1 = a.grab(2)
    _, g1b, d1b = a.grab(2)
    assert torch.equal(g1, g1b) and torch.equal(d1, d1b)
    assert not torch.equal(g1, a.grab(3)[1]) and not torch.equal(g1, b.grab(2)[1])
    _, g0, d0 = clean.grab(2)
    assert 0.5 < float((g1 - g0).std()) < 4.0
    n = kinect_noise_fields(3, 2, 48, 64)
    assert [f.shape for f in n] == [(48, 64)] * 3 and all(f.dtype == np.float32 for f in n)
    np.testing.assert_array_equal(n[2], kinect_noise_fields(3, 2, 48, 64)[2])
    gh, dh = apply_sensor_noise(clean.cam, g0, d0, None, *n)
    assert torch.equal((dh == 0), (d0 <= 0) | torch.from_numpy(n[2] < 0.03))
