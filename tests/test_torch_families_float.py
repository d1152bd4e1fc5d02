"""The descriptor families of rgbdslam_tpu_torch against rgbdslam_tpu: the
ORB x1.2 scale space with steered BRIEF, the SIFT and SURF builds with their
128-D float descriptors, each descriptor module on given keypoints, the L2
matcher, the float codebook and the vocabularies (files, training CLI).

Both packages get the same numpy inputs; one module-scoped JAX build per
variant. Tolerances are stated at each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbdslam_tpu.config import ExtractorConfig as JExtractorConfig
from rgbdslam_tpu.frontend.extractor import Extractor as JExtractor
from rgbdslam_tpu.frontend.matcher import match_descriptors as j_match
from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.io import synthetic as jsyn
from rgbdslam_tpu.loop import codebook as jcodebook
from rgbdslam_tpu.loop import vocabulary as jvoc
from rgbdslam_tpu.ops import descriptors as jdesc
from rgbdslam_tpu.ops import image as jimage
from rgbdslam_tpu.ops import orb as jorb
from rgbdslam_tpu_torch.config import ExtractorConfig
from rgbdslam_tpu_torch.frontend.extractor import Extractor
from rgbdslam_tpu_torch.frontend.matcher import match_descriptors
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.loop import codebook as tcodebook
from rgbdslam_tpu_torch.loop import vocabulary as tvoc
from rgbdslam_tpu_torch.ops import descriptors as tdesc
from rgbdslam_tpu_torch.ops import image as timage
from rgbdslam_tpu_torch.ops import orb as torb
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM_ARGS = dict(fx=200.0, fy=200.0, cx=159.5, cy=119.5, width=320, height=240)
EX = dict(num_features=512, cell_size=8, fast_threshold=15.0)


@pytest.fixture(scope="module")
def frame():
    ds = jsyn.SyntheticDataset(n_frames=128, cam=JCamera(**CAM_ARGS), trajectory="tour",
                               loops=1.15)
    return tuple(np.array(x) for x in ds.grab(40)[1:])


@pytest.fixture(scope="module")
def keypoints(frame):
    """512 integer keypoints inside the 16-pixel border, and the blurred
    frame of each package (equal: the same separable sums)."""
    rng = np.random.default_rng(0)
    uv = np.stack([rng.integers(16, 304, 512), rng.integers(16, 224, 512)], -1)
    gray = frame[0]
    bj = np.asarray(jimage.gaussian_blur(jnp.asarray(gray)))
    bt = timage.gaussian_blur(torch.from_numpy(gray)).numpy()
    np.testing.assert_array_equal(bt, bj)
    return uv.astype(np.float32), gray, bj


def _bits_differ(a, b) -> int:
    return int(np.unpackbits((np.asarray(a).view(np.uint32)
                              ^ np.asarray(b).view(np.uint32)).view(np.uint8)).sum())


# ---------------------------------------------------------------------------
# descriptor modules on given keypoints
# ---------------------------------------------------------------------------


def test_orb_descriptors_match_jax(keypoints):
    """Steered BRIEF: IC angles within 1e-4 rad (moments summed in another
    order), angle bins equal but for counted flips at a bin edge, and the
    bilinear samples' bits >= 99.9 % on equal bins (the taps add in another
    order than XLA's selector matmul; measured: every bit)."""
    uv, gray, blur = keypoints
    dj, aj = jorb.orb_descriptors_dense(jnp.asarray(blur), jnp.asarray(gray), jnp.asarray(uv))
    dt, at = torb.orb_descriptors_dense(torch.from_numpy(blur), torch.from_numpy(gray),
                                        torch.from_numpy(uv))
    aj, at = np.asarray(aj), at.numpy()
    np.testing.assert_allclose(at, aj, rtol=0, atol=1e-4)
    bins_j = np.mod(np.round(aj / (2 * np.pi) * 16).astype(int), 16)
    bins_t = np.mod(np.round(at / (2 * np.pi) * 16).astype(int), 16)
    flips = bins_j != bins_t
    assert flips.mean() <= 0.01
    dj, dt = np.asarray(dj), dt.numpy().view(np.uint32)
    held = 1.0 - _bits_differ(dj[~flips], dt[~flips]) / (256 * (~flips).sum())
    assert held >= 0.999, held


def test_ic_angles_and_steered_gather_match_jax(keypoints):
    """ic_angles (bilinear circle samples) within 1e-4 rad; brief_descriptors
    steered by those angles (the gather formulation) >= 99.9 % of bits."""
    uv, gray, blur = keypoints
    aj = np.asarray(jorb.ic_angles(jnp.asarray(gray), jnp.asarray(uv)))
    at = torb.ic_angles(torch.from_numpy(gray), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(at, aj, rtol=0, atol=1e-4)
    bj = jorb.brief_descriptors(jnp.asarray(blur), jnp.asarray(uv), jnp.asarray(aj))
    bt = torb.brief_descriptors(torch.from_numpy(blur), torch.from_numpy(uv),
                                torch.from_numpy(aj))
    assert _bits_differ(bj, bt.numpy()) <= 0.001 * 512 * 256


@pytest.mark.parametrize("pattern", ["brisk", "freak"])
def test_pattern_descriptors_match_jax(keypoints, pattern):
    """BRISK / FREAK: the patterns equal, the bilinear samples' bits >= 99.9 %
    (measured: every bit)."""
    uv, _, blur = keypoints
    pj = {"brisk": jdesc.brisk_pattern, "freak": jdesc.freak_pattern}[pattern]()
    pt = {"brisk": tdesc.brisk_pattern, "freak": tdesc.freak_pattern}[pattern]()
    np.testing.assert_array_equal(pt, pj)
    dj = jdesc.pattern_descriptors_dense(jnp.asarray(blur), jnp.asarray(uv), pattern)
    dt = tdesc.pattern_descriptors_dense(torch.from_numpy(blur), torch.from_numpy(uv), pattern)
    assert _bits_differ(dj, dt.numpy()) <= 0.001 * 512 * 256


def test_latch_descriptors_match_jax(keypoints):
    """LATCH on the 3x3 block means (XLA's product with the f32 reciprocal of
    9, the box sum in reduce_window's order): the block means and every bit
    exact."""
    import jax

    uv, gray, _ = keypoints
    box_j = np.asarray(jax.jit(lambda x: jimage.box_filter_sum(x, 1) / 9.0)(jnp.asarray(gray)))
    box_t = timage.box_filter_sum_xla(torch.from_numpy(gray), 1) * float(
        np.float32(1) / np.float32(9))
    np.testing.assert_array_equal(box_t.numpy(), box_j)
    dj = jdesc.latch_descriptors_dense(jnp.asarray(box_j), jnp.asarray(uv))
    dt = tdesc.latch_descriptors_dense(box_t, torch.from_numpy(uv))
    np.testing.assert_array_equal(dt.numpy().view(np.uint32), np.asarray(dj))


def test_sift_descriptors_match_jax(keypoints):
    """SIFT-class rows within 1e-5 outside counted orientation-bin flips
    (arctan2 and a floor: a gradient on a bin edge may change bins; at most
    1 % of rows), unit norm."""
    uv, _, blur = keypoints
    dj = np.asarray(jdesc.sift_descriptors_dense(jnp.asarray(blur), jnp.asarray(uv)))
    dt = tdesc.sift_descriptors_dense(torch.from_numpy(blur), torch.from_numpy(uv)).numpy()
    err = np.abs(dt - dj).max(axis=1)
    flips = err > 1e-5
    assert flips.mean() <= 0.01, flips.mean()
    np.testing.assert_allclose(np.linalg.norm(dt, axis=1), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# whole builds: orb (x1.2 scale space), sift, surf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("detector", ["sift", "surf"])
def test_family_build_matches_jax(frame, detector):
    """The whole build of the float families on the half-sample path: every
    keypoint slot exact, the (N, 128) f32 rows within 1e-5 outside counted
    orientation-bin flips (at most 1 % of the rows). The ORB build is held
    in tests/test_torch_families_slam_orb.py, on the frames its SLAM run
    built."""
    jx = JExtractor(JCamera(**CAM_ARGS), JExtractorConfig(**EX), detector=detector)
    tx = Extractor(Camera(**CAM_ARGS), ExtractorConfig(**EX), detector=detector)
    assert tx._resolved()[:3] == jx._resolved()[:3]
    gray, depth = frame
    fj = jx.build(jnp.asarray(gray), jnp.asarray(depth), 15.0)
    ft = tx.build(torch.from_numpy(gray), torch.from_numpy(depth), 15.0)
    for k in ("uv", "level", "valid"):
        np.testing.assert_array_equal(getattr(ft, k).numpy(), np.asarray(getattr(fj, k)),
                                      err_msg=k)
    assert int(ft.valid.sum()) > 400
    dj, dt = np.asarray(fj.desc), ft.desc.numpy()
    assert dt.dtype == np.float32 and dt.shape == (512, 128)
    assert (np.abs(dt - dj).max(axis=1) > 1e-5).mean() <= 0.01


def test_orb_resolves_to_the_scale_space():
    """orb / orb2 resolve to the x1.2, 8-level scale space unless the config
    pins another pyramid, as in the JAX package; the gate scales per
    response."""
    for det in Extractor.DETECTORS:
        jx = JExtractor(JCamera(**CAM_ARGS), JExtractorConfig(**EX), detector=det)
        tx = Extractor(Camera(**CAM_ARGS), ExtractorConfig(**EX), detector=det)
        rj, rt = jx._resolved(), tx._resolved()
        assert rt[:3] == rj[:3], det
        for field in ("scale_factor", "num_levels", "min_response"):
            assert getattr(rt[3], field) == getattr(rj[3], field), (det, field)
    assert Extractor.DETECTORS == JExtractor.DETECTORS


# ---------------------------------------------------------------------------
# L2 matching, the float codebook, vocabularies
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sift_rows(keypoints):
    """Two sets of real SIFT rows (the same keypoints shifted by a pixel)."""
    uv, _, blur = keypoints
    b = torch.from_numpy(blur)
    d1 = tdesc.sift_descriptors_dense(b, torch.from_numpy(uv)).numpy()
    d2 = tdesc.sift_descriptors_dense(b, torch.from_numpy(uv + 1.0)).numpy()
    return d1, d2


def test_l2_matcher_matches_jax(sift_rows):
    """L2 2-NN, ratio and mutual gates: indices and validity exact, distances
    within 1e-5; with a query batch the rows of the unbatched calls."""
    d1, d2 = sift_rows
    rng = np.random.default_rng(1)
    v1, v2 = rng.random(512) > 0.1, rng.random(512) > 0.1
    mj = j_match(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2), 0.9)
    mt = match_descriptors(torch.from_numpy(d1), torch.from_numpy(v1), torch.from_numpy(d2),
                           torch.from_numpy(v2), 0.9)
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    keep = np.asarray(mj.valid)
    assert keep.sum() > 100
    np.testing.assert_array_equal(mt.idx2.numpy()[keep], np.asarray(mj.idx2)[keep])
    np.testing.assert_allclose(mt.dist.numpy()[keep], np.asarray(mj.dist)[keep], atol=1e-5)
    mb = match_descriptors(torch.from_numpy(np.stack([d1, d2])),
                           torch.from_numpy(np.stack([v1, v1])),
                           torch.from_numpy(d2), torch.from_numpy(v2), 0.9)
    assert torch.equal(mb.valid[0], mt.valid) and torch.equal(mb.idx2[0], mt.idx2)


def test_float_codebook_matches_jax(sift_rows):
    """train_codebook_float (maxmin seeding, Lloyd rounds) against the JAX
    package: words within 1e-5, idf within 1e-5; quantize against it exact."""
    d1, d2 = sift_rows
    desc = np.concatenate([d1, d2])
    valid = np.ones(len(desc), bool)
    valid[::7] = False
    wj, ij = jcodebook.train_codebook_float(jnp.asarray(desc), jnp.asarray(valid), 64, 4)
    wt, it = tcodebook.train_codebook_float(torch.from_numpy(desc), torch.from_numpy(valid),
                                            64, 4)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=0, atol=1e-5)
    qj = np.asarray(jcodebook.quantize(jnp.asarray(d1), wj, jnp.asarray(valid[:512])))
    qt = tcodebook.quantize(torch.from_numpy(d1), wt, torch.from_numpy(valid[:512])).numpy()
    np.testing.assert_array_equal(qt, qj)


def test_vocabularies_cross_load(tmp_path, sift_rows):
    """voc_synth_orb.npz is a byte copy and loads in both packages with equal
    words; a float vocabulary saved by either package loads in the other."""
    pt, pj = tvoc.shipped_vocabulary("orb"), jvoc.shipped_vocabulary("orb")
    assert pt != pj and open(pt, "rb").read() == open(pj, "rb").read()
    assert tvoc.shipped_vocabulary("orb2") == pt and tvoc.shipped_vocabulary("sift") is None
    wt, it = tvoc.load_vocabulary(pt, device="cpu")
    wj, ij = jvoc.load_vocabulary(pj)
    assert wt.dtype == torch.int32 and wt.shape == (4096, 8)
    np.testing.assert_array_equal(wt.numpy().view(np.uint32), np.asarray(wj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    d1, _ = sift_rows
    idf = np.linspace(0.1, 2.0, 64).astype(np.float32)
    p1 = str(tmp_path / "port.npz")
    tvoc.save_vocabulary(p1, torch.from_numpy(d1[:64]), torch.from_numpy(idf))
    w, i = jvoc.load_vocabulary(p1)
    np.testing.assert_array_equal(np.asarray(w), d1[:64])
    np.testing.assert_array_equal(np.asarray(i), idf)
    p2 = str(tmp_path / "jax.npz")
    jvoc.save_vocabulary(p2, jnp.asarray(d1[64:128]), jnp.asarray(idf))
    w, i = tvoc.load_vocabulary(p2, device="cpu")
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), d1[64:128])
    np.testing.assert_array_equal(i.numpy(), idf)


@pytest.mark.parametrize("detector", ["brisk", "surf"])
def test_vocabulary_cli_trains_each_family(tmp_path, detector):
    """python -m rgbdslam_tpu_torch.loop.vocabulary on a small synthetic
    orbit (CPU): a binary family gets uint32 words, a float one f32 rows;
    the JAX package loads the file."""
    out = str(tmp_path / f"{detector}.npz")
    rc = tvoc.main(["--dataset", "synthetic:orbit", "--out", out, "--vocab-size", "32",
                    "--detector", detector, "--frames", "2", "--stride", "4",
                    "--width", "160", "--height", "120", "--device", "cpu"])
    assert rc == 0
    w, i = jvoc.load_vocabulary(out)
    w = np.asarray(w)
    assert w.shape == ((32, 8) if detector == "brisk" else (32, 128))
    assert w.dtype == (np.uint32 if detector == "brisk" else np.float32)
    assert np.isfinite(np.asarray(i)).all()


def test_train_vocabulary_from_dataset_on_the_cpu(tmp_path):
    """train_vocabulary_from_dataset runs on the card unless the caller asks
    for the CPU (without a card its default raises); with device="cpu" it
    trains, on the same frames, the codebook that the vocabulary CLI saves:
    words and idf equal."""
    import argparse

    from rgbdslam_tpu_torch.cli import _camera
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset

    cam = _camera(argparse.Namespace(width=160, height=120))
    ds = SyntheticDataset(n_frames=8, cam=cam, trajectory="orbit", device="cpu")
    cfg = ExtractorConfig()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tvoc.train_vocabulary_from_dataset(ds, cam, cfg, vocab_size=32, frame_stride=4,
                                               max_frames=2, detector="brisk")
    words, idf = tvoc.train_vocabulary_from_dataset(ds, cam, cfg, vocab_size=32, iters=8,
                                                    frame_stride=4, max_frames=2,
                                                    detector="brisk", device="cpu")
    assert words.device.type == "cpu" and words.dtype == torch.int32 and words.shape == (32, 8)
    out = str(tmp_path / "brisk.npz")
    assert tvoc.main(["--dataset", "synthetic:orbit", "--out", out, "--vocab-size", "32",
                      "--detector", "brisk", "--frames", "2", "--stride", "4",
                      "--width", "160", "--height", "120", "--device", "cpu"]) == 0
    w, i = tvoc.load_vocabulary(out, device="cpu")
    torch.testing.assert_close(words, w, rtol=0, atol=0)
    torch.testing.assert_close(idf, i, rtol=0, atol=0)
