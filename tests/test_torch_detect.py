"""Detector (K1's plain version), keypoint selection and BRIEF of
rgbdslam_tpu_torch against rgbdslam_tpu on the same numpy images.

The JAX side runs the Pallas detector in interpret mode (as
tests/test_pallas_detect.py does) and the XLA composition it is tested
against. Integer-valued images make every box sum exact in any order, so
keep masks must agree exactly; on float images the raw score is held to the
tolerance of the JAX package's own kernel test (rtol 1e-5, atol 1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.io.synthetic import SyntheticDataset as JDataset
from rgbdslam_tpu.ops import fast as jfast
from rgbdslam_tpu.ops import image as jimg
from rgbdslam_tpu.ops import orb as jorb
from rgbdslam_tpu.ops.pallas_kernels import detect_score_map as j_detect
from rgbdslam_tpu_torch.ops import fast as tfast
from rgbdslam_tpu_torch.ops import image as timg
from rgbdslam_tpu_torch.ops import kernels
from rgbdslam_tpu_torch.ops import orb as torb
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM = JCamera(200.0, 200.0, 159.5, 119.5, width=320, height=240)


def _int_image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)


@pytest.fixture(scope="module")
def rendered():
    _, gray, depth = JDataset(n_frames=24, cam=CAM, trajectory="sweep").grab(3)
    return np.asarray(gray), np.asarray(depth)


@pytest.mark.parametrize("shape,thr", [((240, 320), 20.0), ((60, 80), 15.0),
                                       ((30, 40), 10.0)])
def test_detect_ref_matches_pallas_and_xla_on_integer_images(shape, thr):
    img = _int_image(shape, seed=shape[0] + int(thr))
    tm, tr = kernels.detect_score_map_ref(torch.from_numpy(img), thr)
    tm, tr = tm.numpy(), tr.numpy()
    for use_pallas in (True, False):
        if use_pallas:
            jm, jr = j_detect(jnp.asarray(img), thr, interpret=True)
        else:
            jm, jr = jfast.masked_score_map(jnp.asarray(img), thr, use_pallas=False)
        jm, jr = np.asarray(jm), np.asarray(jr)
        np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-3)
        keep = np.isfinite(jm)
        np.testing.assert_array_equal(np.isfinite(tm), keep)
        assert keep.sum() > 0
        np.testing.assert_allclose(tm[keep], jm[keep], rtol=1e-5, atol=1e-3)


def test_detect_ref_matches_pallas_on_rendered_levels(rendered):
    """Float images: the plain version sums in the Pallas kernel's order, so
    the maps agree to f32 rounding and the keep masks agree exactly."""
    gray, _ = rendered
    pj = jimg.build_pyramid(jnp.asarray(gray), 3)
    pt = timg.build_pyramid(torch.from_numpy(gray), 3)
    for a, b in zip(pj, pt):
        jm, jr = (np.asarray(x) for x in j_detect(a, 15.0, interpret=True))
        tm, tr = (x.numpy() for x in kernels.detect_score_map_ref(b, 15.0))
        np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(np.isfinite(tm), np.isfinite(jm))


def test_masked_score_map_dispatches_to_plain_version_on_cpu():
    img = torch.from_numpy(_int_image((60, 80), seed=9))
    kernels.reset_launch_counts()
    a = tfast.masked_score_map(img, 20.0)
    b = kernels.detect_score_map_ref(img, 20.0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert kernels.LAUNCHES["detect_score_map"] == 0
    with pytest.raises(ValueError):
        kernels.detect_score_map(img, 20.0)          # the kernel takes CUDA tensors only


def test_detect_keypoints_match_on_integer_pyramid():
    img = _int_image((240, 320), seed=11)
    pj = [jnp.asarray(img), jnp.asarray(img[::2, ::2])]
    pt = [torch.from_numpy(img), torch.from_numpy(np.ascontiguousarray(img[::2, ::2]))]
    kw = dict(num_features=256, cell_size=10, fast_threshold=20.0,
              min_response=20.0, min_border=8)
    kj = jfast.detect_keypoints(pj, use_pallas=False, **kw)
    kt = tfast.detect_keypoints(pt, **kw)
    # same cells in the same order (top_k and the stable sort both put the
    # lower cell index first on equal scores)
    np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
    np.testing.assert_array_equal(kt.uv.numpy(), np.asarray(kj.uv))
    np.testing.assert_array_equal(kt.level.numpy(), np.asarray(kj.level))
    np.testing.assert_allclose(kt.score.numpy(), np.asarray(kj.score), rtol=1e-5, atol=1e-3)


def test_detect_keypoints_match_on_rendered_frame(rendered):
    gray, _ = rendered
    kw = dict(num_features=1024, cell_size=8, fast_threshold=15.0,
              min_response=20.0, min_border=16)
    kj = jfast.detect_keypoints(jimg.build_pyramid(jnp.asarray(gray), 3), **kw)
    kt = tfast.detect_keypoints(timg.build_pyramid(torch.from_numpy(gray), 3), **kw)
    v = np.asarray(kj.valid)
    assert v.sum() > 300
    np.testing.assert_array_equal(kt.valid.numpy(), v)
    np.testing.assert_array_equal(kt.uv.numpy(), np.asarray(kj.uv))
    np.testing.assert_array_equal(kt.level.numpy(), np.asarray(kj.level))


def test_brief_bits_identical_on_rendered_frame(rendered):
    gray, _ = rendered
    rng = np.random.default_rng(12)
    uv = rng.integers(16, [304, 224], size=(512, 2)).astype(np.float32)
    uv[:4] = [[0, 0], [319, 239], [2, 237], [5.5, 6.5]]     # clamped reads, rounding
    dj = np.asarray(jorb.brief_descriptors_dense(jimg.gaussian_blur(jnp.asarray(gray)),
                                                 jnp.asarray(uv)))
    dt = torb.brief_descriptors_dense(timg.gaussian_blur(torch.from_numpy(gray)),
                                      torch.from_numpy(uv))
    assert dt.dtype == torch.int32
    np.testing.assert_array_equal(dt.numpy().view(np.uint32), dj)
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())


def test_pack_bits_matches():
    rng = np.random.default_rng(13)
    bits = rng.random((64, 256)) > 0.5
    bits[0] = True                                           # 0xFFFFFFFF words
    a = np.asarray(jorb._pack_bits(jnp.asarray(bits)))
    b = torb._pack_bits(torch.from_numpy(bits)).numpy().view(np.uint32)
    np.testing.assert_array_equal(b, a)
