"""Projection-guided matching, the camera model's leftovers and
`se3.identity` / `se3.adjoint`, rgbdslam_tpu_torch against rgbdslam_tpu on
the same inputs, and the JAX suite's behaviour tests of them
(tests/test_parity_extras.py:20-78) on the port alone.

Tolerances: `projection_match` exact (idx2, dist and valid on features the
JAX package built, converted once); the camera functions and the se3
leftovers within 1e-6 (`in_bounds` exact). The random camera hooks draw
from a torch.Generator: they are held by what they promise (inside the
image, inside the depth range), not by jax.random's stream. The behaviour
tests keep the JAX tests' own bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.config import ExtractorConfig as JExtractorConfig
from rgbdslam_tpu.frontend.frame import build_frame_features as j_build
from rgbdslam_tpu.frontend.matcher import projection_match as j_projection_match
from rgbdslam_tpu.geometry import camera as jcam
from rgbdslam_tpu.geometry import se3 as jse3
from rgbdslam_tpu.io.synthetic import SyntheticDataset as JSyntheticDataset
from rgbdslam_tpu_torch import convert
from rgbdslam_tpu_torch.config import ExtractorConfig
from rgbdslam_tpu_torch.frontend.frame import build_frame_features
from rgbdslam_tpu_torch.frontend.matcher import match_frames, projection_match
from rgbdslam_tpu_torch.geometry import camera as tcam
from rgbdslam_tpu_torch.geometry import se3 as tse3
from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM = tcam.Camera(160.0, 160.0, 127.5, 95.5, width=256, height=192)
JCAM = jcam.Camera(160.0, 160.0, 127.5, 95.5, width=256, height=192)
DIST = tcam.TUM_FR1      # a camera with radial-tangential distortion
CFG = ExtractorConfig(num_features=512, num_levels=3, cell_size=8, fast_threshold=15.0)
JCFG = JExtractorConfig(num_features=512, num_levels=3, cell_size=8, fast_threshold=15.0)
T = torch.from_numpy


def _T21(poses, i=0, j=1):
    return (np.linalg.inv(poses[j]) @ poses[i]).astype(np.float32)


# ------------------------------------------------------------------ parity


@pytest.fixture(scope="module")
def jax_pair():
    """Sweep frames 0 and 1 built by the JAX package: (JAX features, port
    features on the CPU, the true T21)."""
    ds = JSyntheticDataset(n_frames=40, cam=JCAM, trajectory="sweep")
    out = []
    for i in (0, 1):
        _, g, d = ds.grab(i)
        f = j_build(JCAM, jnp.asarray(g), jnp.asarray(d), JCFG)
        host = {n: np.asarray(getattr(f, n)) for n in convert.FEATURE_FIELDS}
        out.append((f, convert.frame_features_from_numpy(host, device="cpu")))
    return out, _T21(ds.poses_twc)


@pytest.mark.parametrize("prior", ["true", "wrong"])
def test_projection_match_matches_jax(jax_pair, prior):
    ((jf0, tf0), (jf1, tf1)), T21 = jax_pair
    if prior == "wrong":
        T21 = np.eye(4, dtype=np.float32)
        T21[0, 3] = 1.5
    mj = j_projection_match(jf0, jf1, jnp.asarray(T21), JCAM)
    mt = projection_match(tf0, tf1, T(T21), CAM)
    np.testing.assert_array_equal(mt.idx2.numpy(), np.asarray(mj.idx2))
    np.testing.assert_array_equal(mt.dist.numpy(), np.asarray(mj.dist))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    assert int(mt.valid.sum()) > (50 if prior == "true" else 0)


def test_camera_functions_match_jax():
    rng = np.random.default_rng(0)
    xn = rng.uniform(-0.6, 0.6, (64, 2)).astype(np.float32)
    jd = jcam.Camera(*[getattr(DIST, f) for f in ("fx", "fy", "cx", "cy", "k1", "k2", "k3",
                                                   "p1", "p2", "depth_factor")])
    np.testing.assert_allclose(tcam.distort_normalized(DIST, T(xn)).numpy(),
                               np.asarray(jcam.distort_normalized(jd, jnp.asarray(xn))),
                               atol=1e-6)
    pts = np.stack([rng.uniform(-1, 1, 64), rng.uniform(-1, 1, 64),
                    rng.uniform(0.3, 5, 64)], -1).astype(np.float32)
    pts[0, 2] = 0.0                                  # the guarded division
    np.testing.assert_allclose(tcam.project(CAM, T(pts)).numpy(),
                               np.asarray(jcam.project(JCAM, jnp.asarray(pts))),
                               rtol=1e-6, atol=1e-6)
    uv = rng.uniform(-20, 280, (64, 2)).astype(np.float32)
    np.testing.assert_allclose(tcam.bearing(CAM, T(uv)).numpy(),
                               np.asarray(jcam.bearing(JCAM, jnp.asarray(uv))), atol=1e-6)
    for border in (0.0, 7.5):
        np.testing.assert_array_equal(
            tcam.in_bounds(CAM, T(uv), border).numpy(),
            np.asarray(jcam.in_bounds(JCAM, jnp.asarray(uv), border)))


def test_se3_leftovers_match_jax():
    rng = np.random.default_rng(1)
    xi = rng.normal(0, 0.5, (16, 6)).astype(np.float32)
    Tm = tse3.exp(T(xi))
    np.testing.assert_allclose(tse3.adjoint(Tm).numpy(),
                               np.asarray(jse3.adjoint(jnp.asarray(Tm.numpy()))), atol=1e-6)
    np.testing.assert_array_equal(tse3.identity(device="cpu").numpy(),
                                  np.asarray(jse3.identity()))
    assert tse3.identity(torch.float64, "cpu").dtype == torch.float64
    # Ad(T) xi is the tangent of T exp(xi) T^-1
    x = T(rng.normal(0, 0.1, 6).astype(np.float32))
    lhs = Tm[0] @ tse3.exp(x) @ tse3.inverse(Tm[0])
    np.testing.assert_allclose(lhs.numpy(), tse3.exp(tse3.adjoint(Tm[0]) @ x).numpy(),
                               atol=1e-5)


def test_random_camera_hooks_promises():
    gen = torch.Generator().manual_seed(0)
    uv = tcam.random_keypoints(CAM, gen, 256, border=20.0)
    assert uv.shape == (256, 2) and tcam.in_bounds(CAM, uv, 20.0).all()
    pts = tcam.random_visible_points(CAM, gen, 256, z_range=(0.5, 4.0))
    z = pts[:, 2].numpy()
    assert (z >= 0.5).all() and (z <= 4.0).all()
    assert tcam.in_bounds(CAM, tcam.project(CAM, pts)).all()
    # the same generator state gives the same draws; another seed others
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(tcam.random_keypoints(CAM, g1, 8), tcam.random_keypoints(CAM, g2, 8))


def test_entry_points_default_to_the_card():
    """se3.identity, like every entry point, asks for the card by default."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tse3.identity()


# ------------------------------------------------- behaviour (port alone)


@pytest.fixture(scope="module")
def port_pair():
    ds = SyntheticDataset(n_frames=40, cam=CAM, trajectory="sweep", device="cpu")
    feats = []
    for i in (0, 1):
        _, g, d = ds.grab(i)
        feats.append(build_frame_features(CAM, g, d, CFG))
    return feats, _T21(ds.poses_twc)


def test_projection_match_on_synthetic_pair(port_pair):
    (f0, f1), T21 = port_pair
    m = projection_match(f0, f1, T(T21), CAM)
    n = int(m.valid.sum())
    assert n > 50, n
    v = m.valid.numpy()
    p1 = f0.xyz.numpy()[v]
    p2 = f1.xyz.numpy()[m.idx2.numpy()][v]
    err = np.linalg.norm(p1 @ T21[:3, :3].T + T21[:3, 3] - p2, axis=-1)
    assert np.median(err) < 0.05
    assert n >= 0.5 * int(match_frames(f0, f1).num_matches)


def test_projection_match_wrong_prior_yields_few(port_pair):
    (f0, f1), T_right = port_pair
    T_wrong = np.eye(4, dtype=np.float32)
    T_wrong[0, 3] = 1.5
    m_right = projection_match(f0, f1, T(T_right), CAM)
    m_wrong = projection_match(f0, f1, T(T_wrong), CAM)
    assert int(m_wrong.valid.sum()) < 0.7 * int(m_right.valid.sum())
    v = m_wrong.valid.numpy()
    p1 = f0.xyz.numpy()[v]
    p2 = f1.xyz.numpy()[m_wrong.idx2.numpy()][v]
    err = np.linalg.norm(p1 @ T_right[:3, :3].T + T_right[:3, 3] - p2, axis=-1)
    assert np.median(err) > 0.2


def test_random_camera_hooks():
    gen = torch.Generator().manual_seed(0)
    uv = tcam.random_keypoints(CAM, gen, 64)
    assert tcam.in_bounds(CAM, uv).all()
    pts = tcam.random_visible_points(CAM, gen, 64)
    proj = tcam.project(CAM, pts).numpy()
    assert (proj[:, 0] >= 0).all() and (proj[:, 0] <= CAM.width - 1).all()
    assert (pts.numpy()[:, 2] >= 0.5).all()
