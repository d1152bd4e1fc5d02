"""The detector families of rgbdslam_tpu_torch against rgbdslam_tpu: K1's
GFTT mode, the x1.2 scale-space pyramid, the final response gate at a moved
FAST threshold (fault F6) in the builds, the serial ADAPTIVE retry and the
batched scan, subpixel refinement, and the feature builds of the binary
families (gftt, star, brisk, freak, latch) at 320x240 with 512 features.

Both packages get the same rendered numpy frames; the port's K1 is held
against the Pallas kernel in interpret mode, and the JAX builds run the
detector through its plain reference (the XLA composition the JAX package's
tests hold the kernel to), one module-scoped build per variant.
Tolerances (stated at each test): K1 and every integer field exact; the
pyramid within 1e-4 of the frame's 255 range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbdslam_tpu.config import ExtractorConfig as JExtractorConfig
from rgbdslam_tpu.frontend.extractor import Extractor as JExtractor
from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.io import synthetic as jsyn
from rgbdslam_tpu.ops import fast as jfast
from rgbdslam_tpu.ops import image as jimage
from rgbdslam_tpu.ops.pallas_kernels import detect_score_map as j_detect_score_map
from rgbdslam_tpu_torch.config import ExtractorConfig, SlamConfig
from rgbdslam_tpu_torch.frontend.extractor import Extractor
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.ops import fast, image, kernels
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM_ARGS = dict(fx=200.0, fy=200.0, cx=159.5, cy=119.5, width=320, height=240)
EX = dict(num_features=512, cell_size=8, fast_threshold=15.0)


@pytest.fixture(autouse=True, scope="module")
def _jax_detector_through_its_plain_reference():
    """The JAX builds run the Pallas detector through its plain reference,
    masked_score_map(use_pallas=False): the XLA composition that the JAX
    package's tests (tests/test_pallas_detect.py) hold the kernel to, at
    about a third of interpret mode's compile time.
    test_k1_plain_modes_match_pallas holds the port's K1 against the kernel
    itself. The jitted programs
    traced meanwhile are dropped afterwards."""
    orig = jfast.masked_score_map

    def plain(img, fast_threshold, use_fast_gate=True, use_pallas=True):
        return orig(img, fast_threshold, use_fast_gate, use_pallas=False)

    jfast.masked_score_map = plain
    yield
    jfast.masked_score_map = orig
    jax.clear_caches()


@pytest.fixture(scope="module")
def frames():
    """A sweep frame and a tour frame, rendered once by the JAX package."""
    sweep = jsyn.SyntheticDataset(n_frames=24, cam=JCamera(**CAM_ARGS), trajectory="sweep")
    tour = jsyn.SyntheticDataset(n_frames=128, cam=JCamera(**CAM_ARGS), trajectory="tour",
                                 loops=1.15)
    return [tuple(np.array(x) for x in ds.grab(i)[1:]) for ds, i in ((sweep, 5), (tour, 40))]


def _extractors(detector, **kw):
    return (JExtractor(JCamera(**CAM_ARGS), JExtractorConfig(**EX, **kw), detector=detector),
            Extractor(Camera(**CAM_ARGS), ExtractorConfig(**EX, **kw), detector=detector))


def _assert_keypoints_equal(fj, ft):
    """Every slot, valid or not: uv, level, valid exact; scores to f32
    rounding (the same Shi-Tomasi arithmetic, summed as the kernels sum)."""
    for k in ("uv", "level", "valid"):
        np.testing.assert_array_equal(getattr(ft, k).numpy(), np.asarray(getattr(fj, k)),
                                      err_msg=k)
    np.testing.assert_allclose(ft.score.numpy(), np.asarray(fj.score), rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# K1's GFTT mode and the pyramid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fast_gate", [False, True])
def test_k1_plain_modes_match_pallas(frames, fast_gate):
    """detect_score_map_ref against the Pallas kernel (interpret mode) in
    both modes, as tests/test_torch_detect.py holds the FAST mode: the scores
    within f32 rounding (the same Shi-Tomasi arithmetic; XLA contracts part
    of it into fused multiply-adds), the keep mask exact with the FAST gate.
    Without it every 3x3 maximum of the raw map is kept, and a near-tie
    there follows those ulps: the mask is held to all but 1e-4 of the
    pixels (measured: 1 of 76,800)."""
    for gray, _ in frames:
        mj, rj = (np.asarray(a) for a in j_detect_score_map(jnp.asarray(gray), 15.0,
                                                            use_fast_gate=fast_gate))
        for thr in (15.0, torch.tensor(15.0)):
            mt, rt = (a.numpy() for a in kernels.detect_score_map_ref(
                torch.from_numpy(gray.copy()), thr, fast_gate))
            keep = np.isfinite(mj)
            if fast_gate:
                np.testing.assert_array_equal(np.isfinite(mt), keep)
            else:
                assert (np.isfinite(mt) != keep).mean() <= 1e-4
            keep &= np.isfinite(mt)
            np.testing.assert_allclose(mt[keep], mj[keep], rtol=1e-5, atol=1e-3)
            np.testing.assert_allclose(rt, rj, rtol=1e-5, atol=1e-3)
            assert keep.sum() > 500


def test_resize_weights_match_jax():
    """The tap weights of the x1.2 resize against jax.image's weight matrix:
    the same support, each weight within 2 ulps of 1 (a few differ in the
    last bit)."""
    from jax._src.image import scale as jscale

    for n_in, n_out in ((480, 400), (640, 533), (240, 200), (134, 112)):
        wj = np.asarray(jax.jit(lambda: jscale.compute_weight_mat(
            n_in, n_out, n_out / n_in, 0.0, jscale._fill_triangle_kernel, True))())
        idx, w = image._resize_taps_np(n_in, n_out)
        wt = np.zeros_like(wj)
        for t in range(idx.shape[0]):
            np.add.at(wt, (idx[t], np.arange(n_out)), w[t])
        np.testing.assert_array_equal(wt != 0, wj != 0)
        np.testing.assert_allclose(wt, wj, rtol=0, atol=2.5e-7)


def test_scaled_pyramid_matches_jax(frames):
    """build_scaled_pyramid (x1.2, 8 levels) against jax.image.resize's
    antialiased chain: equal shapes, level 0 the frame itself, every level
    within 2e-6 relative (tap sums against XLA's matmul: a few ulps of
    values up to 255, carried down the chain; measured at most 1.4e-4
    absolute, 9.7e-7 relative)."""
    for gray, _ in frames:
        pj = jimage.build_scaled_pyramid(jnp.asarray(gray), 8, 1.2)
        pt = image.build_scaled_pyramid(torch.from_numpy(gray), 8, 1.2)
        assert [tuple(p.shape) for p in pt] == [p.shape for p in pj]
        assert [tuple(p.shape) for p in pt] == image.scaled_pyramid_shapes(240, 320, 8, 1.2)
        np.testing.assert_array_equal(pt[0].numpy(), np.asarray(pj[0]))
        for a, b in zip(pt[1:], pj[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=0)


def test_level_quotas_match_jax():
    from rgbdslam_tpu.ops.fast import level_quotas as j_quotas

    for n, levels, cell, (h, w) in ((1024, 8, 16, (480, 640)), (512, 8, 8, (240, 320)),
                                    (256, 8, 8, (120, 160)), (1024, 4, 16, (120, 160))):
        shapes = image.scaled_pyramid_shapes(h, w, levels, 1.2)
        q = fast.level_quotas(n, levels, 1.2, cell, shapes)
        assert q == j_quotas(n, levels, 1.2, cell, shapes) and sum(q) == n


# ---------------------------------------------------------------------------
# F6: the response gate scales with the FAST threshold
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def svo_pair():
    return _extractors("svo_fast")


@pytest.mark.parametrize("factor", [0.3, 0.7, 1.0, 1.5, 2.0])
def test_response_gate_follows_the_threshold(frames, svo_pair, factor):
    """F6: at thresholds cfg x {0.3, 0.7, 1, 1.5, 2}, given as a float and as
    a 0-dim tensor, the port keeps JAX's keypoints in every slot: the gate
    is min_response * (thr / cfg threshold)^2 as XLA computes it."""
    je, te = svo_pair
    gray, depth = frames[0]
    t = 15.0 * factor
    fj = je.build(jnp.asarray(gray), jnp.asarray(depth), t)
    for thr in (t, torch.tensor(t, dtype=torch.float32)):
        ft = te.build(torch.from_numpy(gray), torch.from_numpy(depth), thr)
        _assert_keypoints_equal(fj, ft)
        np.testing.assert_array_equal(ft.desc.numpy().view(np.uint32), np.asarray(fj.desc))
    if factor == 2.0:
        assert int(ft.valid.sum()) < 512        # the raised gate drops keypoints


def test_gate_in_adaptive_retry_and_batched_scan(frames):
    """F6 in the two ADAPTIVE paths: the serial extractor's within-frame
    re-detections from threshold 60 (each at a lowered threshold) end at
    JAX's threshold with JAX's keypoints; batch_body builds at the carried
    device threshold with JAX's keypoints and counts."""
    from rgbdslam_tpu_torch.slam.tracking import batch_body

    gray, depth = frames[1]
    # fresh extractors of svo_pair's configuration: the JAX side reuses its
    # compiled build (the jit caches on the camera and config)
    je, te = _extractors("svo_fast")
    je.adaptive = te.adaptive = True
    je.target_min = te.target_min = 400
    je.threshold = te.threshold = 60.0
    fj = je(jnp.asarray(gray), jnp.asarray(depth))
    ft = te(torch.from_numpy(gray), torch.from_numpy(depth))
    assert te.reads >= 2 and te.threshold == pytest.approx(je.threshold, rel=0, abs=0)
    _assert_keypoints_equal(fj, ft)

    cfg = SlamConfig(extractor=ExtractorConfig(**EX), adaptive=True)
    g, d = torch.from_numpy(gray), torch.from_numpy(depth)
    f_prev = te.build(g, d, 15.0)
    for t in (30.0, 9.0):
        fj = je.build(jnp.asarray(gray), jnp.asarray(depth), t)
        f_cur, _, _, thr_new, row = batch_body(te, cfg, f_prev, torch.eye(4), d,
                                               torch.tensor(t), g, d,
                                               torch.Generator().manual_seed(0))
        _assert_keypoints_equal(fj, f_cur)
        assert float(row[20]) == float(np.asarray(fj.valid).sum())      # n_valid


# ---------------------------------------------------------------------------
# the binary families' builds, subpixel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("detector", ["gftt", "star", "brisk", "freak", "latch"])
def test_family_build_matches_jax(frames, detector):
    """The whole build of a binary family on the half-sample path. Exact:
    every keypoint slot and, on equal keypoints, every descriptor bit (gftt,
    star and latch sample integer offsets; brisk and freak bilinear taps,
    which equal XLA's here). Star's response is XLA code whose fused
    multiply-adds the port follows on each map; on the frame's third level
    XLA's fusion rounds part of the map apart, so star is held to 99 % of
    its slots (measured: 510 of 512)."""
    je, te = _extractors(detector)
    gray, depth = frames[0]
    fj = je.build(jnp.asarray(gray), jnp.asarray(depth), 15.0)
    ft = te.build(torch.from_numpy(gray), torch.from_numpy(depth), 15.0)
    uvj, uvt = np.asarray(fj.uv), ft.uv.numpy()
    same = (uvj == uvt).all(axis=1)
    if detector == "star":
        assert same.mean() >= 0.99, same.mean()
    else:
        _assert_keypoints_equal(fj, ft)
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    assert int(ft.valid.sum()) > 400
    np.testing.assert_array_equal(ft.desc.numpy().view(np.uint32)[same],
                                  np.asarray(fj.desc)[same])
    for k in ("has_depth", "smooth", "intensity"):
        np.testing.assert_array_equal(getattr(ft, k).numpy()[same],
                                      np.asarray(getattr(fj, k))[same], err_msg=k)


@pytest.mark.parametrize("detector", ["svo_fast"])
def test_subpixel_build_matches_jax(frames, detector):
    """Subpixel refinement on the half-sample path (every slot moves by its
    level's parabola offsets on the raw map): uv within 1e-4 px (the raw
    Shi-Tomasi maps differ from the Pallas kernel's by ulps, which the
    parabola's small denominators magnify; measured 6.1e-5 px), the
    integer fields exact."""
    je, te = _extractors(detector, subpixel=True)
    gray, depth = frames[1]
    fj = je.build(jnp.asarray(gray), jnp.asarray(depth), 15.0)
    ft = te.build(torch.from_numpy(gray), torch.from_numpy(depth), 15.0)
    np.testing.assert_allclose(ft.uv.numpy(), np.asarray(fj.uv), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_array_equal(ft.level.numpy(), np.asarray(fj.level))
    assert (ft.uv.numpy() != np.round(ft.uv.numpy())).mean() > 0.5
