"""rgbdslam_tpu_torch against rgbdslam_tpu: config, SE(3), camera and image
ops on the same numpy inputs, plus the package's import hygiene.

Tolerances: results of identical f32 operation sequences are compared
exactly; results whose summation or library kernels differ (matmuls, the
box-filter reduction order) within a few f32 ulps of their magnitude, as
stated at each assert.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbdslam_tpu import config as jcfg
from rgbdslam_tpu.geometry import camera as jcam
from rgbdslam_tpu.geometry import se3 as jse3
from rgbdslam_tpu.ops import image as jimg
from rgbdslam_tpu_torch import config as tcfg
from rgbdslam_tpu_torch import convert
from rgbdslam_tpu_torch.geometry import camera as tcam
from rgbdslam_tpu_torch.geometry import se3 as tse3
from rgbdslam_tpu_torch.ops import image as timg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cls):
    def plain(v):
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v

    return [(f.name, plain(f.default)) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ExtractorConfig", "MatcherConfig", "RansacConfig",
                                  "IcpConfig", "KeyframeConfig", "PoseGraphConfig",
                                  "LoopConfig", "SlamConfig"])
def test_config_fields_and_defaults_match(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


def test_config_from_jax_round_trip():
    j = jcfg.SlamConfig(extractor=jcfg.ExtractorConfig(num_levels=3, cell_size=8),
                        ransac=jcfg.RansacConfig(num_hypotheses=128),
                        image_size=(240, 320))
    t = convert.config_from_jax(j)
    assert isinstance(t, tcfg.SlamConfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_se3_exp_hat_from_rt_match():
    rng = np.random.default_rng(0)
    xi = rng.normal(scale=0.3, size=(64, 6)).astype(np.float32)
    xi[:4, 3:] *= 1e-5                      # small-angle Taylor branch
    a = np.asarray(jse3.exp(jnp.asarray(xi)))
    b = tse3.exp(torch.from_numpy(xi)).numpy()
    # 3x3 products: XLA and torch matmuls may order the 3-term sums
    # differently -> a few f32 ulps of O(1) entries
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(tse3.hat(torch.from_numpy(xi[:, 3:])).numpy(),
                                  np.asarray(jse3.hat(jnp.asarray(xi[:, 3:]))))
    R, t = a[:, :3, :3], a[:, :3, 3]
    np.testing.assert_array_equal(
        tse3.from_Rt(torch.from_numpy(R), torch.from_numpy(t)).numpy(),
        np.asarray(jse3.from_Rt(jnp.asarray(R), jnp.asarray(t))))


def test_quaternion_conversions_match():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    Rj = np.asarray(jse3.rotation_from_quat(jnp.asarray(q)))
    Rt = tse3.rotation_from_quat(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-6)   # same elementwise ops
    qj = np.asarray(jse3.quat_from_rotation(jnp.asarray(Rj)))
    qt = tse3.quat_from_rotation(torch.from_numpy(Rj)).numpy()
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-6)


def test_host_pose_helpers_match():
    rng = np.random.default_rng(2)
    T = np.asarray(jse3.exp(jnp.asarray(rng.normal(scale=0.5, size=(8, 6)).astype(np.float32))))
    T = T.copy()
    T[:, :3, :3] *= 1.0 + 1e-4               # scale drift to be projected out
    np.testing.assert_array_equal(tse3.inverse_np(T), jse3.inverse_np(T))
    np.testing.assert_array_equal(tse3.orthonormalize_np(T), jse3.orthonormalize_np(T))
    R = tse3.orthonormalize_np(T)[:, :3, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-6)


@pytest.mark.parametrize("cam_name", ["TUM_FR1", "SYNTHETIC"])
def test_camera_undistort_unproject_match(cam_name):
    cj, ct = getattr(jcam, cam_name), getattr(tcam, cam_name)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    rng = np.random.default_rng(3)
    uv = rng.uniform([0, 0], [639, 479], size=(512, 2)).astype(np.float32)
    z = rng.uniform(0.0, 7.0, size=512).astype(np.float32)
    z[:8] = [0.0, 0.05, 0.1, 6.0, 6.5, np.inf, np.nan, 3.0]
    a = np.asarray(jcam.undistort_pixels(cj, jnp.asarray(uv)))
    b = tcam.undistort_pixels(ct, torch.from_numpy(uv)).numpy()
    # the same 8-step fixed-point iteration in f32; ulp-level differences
    # from the compilers' expression ordering of the polynomial
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        tcam.unproject(ct, torch.from_numpy(a), torch.from_numpy(z)).numpy(),
        np.asarray(jcam.unproject(cj, jnp.asarray(a), jnp.asarray(z))), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tcam.valid_depth(ct, torch.from_numpy(z)).numpy(),
                                  np.asarray(jcam.valid_depth(cj, jnp.asarray(z))))


@pytest.mark.parametrize("shape", [(240, 320), (61, 83)])
def test_image_ops_match(shape):
    rng = np.random.default_rng(4)
    img = (rng.random(shape) * 255).astype(np.float32)
    ij, it = jnp.asarray(img), torch.from_numpy(img)
    # half-sample: the same 4-term sum order -> bit-identical
    pj = jimg.build_pyramid(ij, 3)
    pt = timg.build_pyramid(it, 3)
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # blur: same separable shift-and-add order -> bit-identical
    np.testing.assert_array_equal(timg.gaussian_blur(it).numpy(),
                                  np.asarray(jimg.gaussian_blur(ij)))
    for a, b in zip(jimg.sobel_gradients(ij), timg.sobel_gradients(it)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # box sums: reduce_window vs the separable pass sum in different orders;
    # sums of up to 81 values < 255 -> ~1e-6 relative
    for r in (1, 2, 4):
        np.testing.assert_allclose(timg.box_filter_sum(it, r).numpy(),
                                   np.asarray(jimg.box_filter_sum(ij, r)), rtol=2e-6, atol=0)
    uv = rng.uniform(-3, max(shape) + 3, size=(300, 2)).astype(np.float32)
    uv[:4] = [[0.5, 0.5], [1.5, 2.5], [2.5, 1.5], [10.0, 10.0]]   # round half to even
    np.testing.assert_array_equal(timg.nearest_sample(it, torch.from_numpy(uv)).numpy(),
                                  np.asarray(jimg.nearest_sample(ij, jnp.asarray(uv))))


def test_box_filter_exact_on_integers():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (50, 70)).astype(np.float32)
    for r in (1, 2, 4):
        np.testing.assert_array_equal(
            timg.box_filter_sum(torch.from_numpy(img), r).numpy(),
            np.asarray(jimg.box_filter_sum(jnp.asarray(img), r)))


def test_port_imports_without_jax():
    """Every module of the port imports with jax and flax blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import rgbdslam_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'rgbdslam_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.startswith('rgbdslam_tpu.') or k == 'rgbdslam_tpu' for k in sys.modules)\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_torch_matmul_precision_pinned():
    import rgbdslam_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
