"""K1's modes and the extractor families of rgbdslam_tpu_torch on the card
against their plain versions and the port's CPU build. Every test here is
marked `gpu` and skips without a card:

  python -m pytest --noconftest -m gpu tests/test_torch_gpu_families.py

Tolerances: K1's maps and keypoints exact against the plain versions on
the card (built with -fmad=false, the plain version's operation order); the
feature build of every variant on the card against the CPU build: keypoint
positions, levels and validity exact (subpixel positions within 1e-4 px),
scores within f32 rounding, binary descriptors to 99.9 % of their bits and
SIFT-class rows within 1e-5 outside counted orientation-bin flips (the
card's tensor code rounds apart from the CPU's by ulps).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

VARIANTS = ["svo_fast", "orb", "gftt", "star", "brisk", "freak", "latch", "sift", "surf"]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def kernels(dev):
    from rgbdslam_tpu_torch.ops import kernels as k

    return k


@pytest.fixture(scope="module")
def tour_frames():
    from rgbdslam_tpu_torch.geometry.camera import Camera
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset

    cam = Camera(fx=262.5, fy=262.5, cx=159.5, cy=119.5, width=320, height=240)
    ds = SyntheticDataset(n_frames=128, cam=cam, trajectory="tour", loops=1.15, device="cpu")
    return cam, [ds.grab(i)[1:] for i in (0, 40, 90)]


def _maps_equal(a, b):
    return bool(torch.equal(torch.isfinite(a), torch.isfinite(b))
                and torch.equal(a[torch.isfinite(a)], b[torch.isfinite(b)]))


@pytest.mark.parametrize("shape", [(480, 640), (400, 533), (134, 179), (61, 83)])
@pytest.mark.parametrize("fast_gate", [True, False])
def test_dense_kernel_modes_match_plain(dev, kernels, shape, fast_gate):
    g = torch.Generator(device=dev).manual_seed(shape[0])
    img = torch.randint(0, 256, shape, generator=g, device=dev).to(torch.float32)
    for thr in (20.0, torch.full((), 20.0, device=dev)):
        km, kr = kernels.detect_score_map(img, thr, fast_gate)
        pm, pr = kernels.detect_score_map_ref(img, 20.0, fast_gate)
        assert torch.equal(kr, pr)
        assert _maps_equal(km, pm)
    assert int(torch.isfinite(km).sum()) > 0


def test_dense_kernel_reads_the_device_threshold(dev, kernels):
    g = torch.Generator(device=dev).manual_seed(3)
    img = torch.randint(0, 256, (240, 320), generator=g, device=dev).to(torch.float32)
    thr = torch.full((), 10.0, device=dev)
    a = kernels.detect_score_map(img, thr)[0].clone()
    thr.fill_(40.0)                       # rewritten on the device: no host read
    b = kernels.detect_score_map(img, thr)[0]
    assert _maps_equal(a, kernels.detect_score_map_ref(img, 10.0)[0])
    assert _maps_equal(b, kernels.detect_score_map_ref(img, 40.0)[0])
    assert torch.isfinite(a).sum() > torch.isfinite(b).sum()


def _pyramid(dev, seed, shape=(480, 640)):
    from rgbdslam_tpu_torch.ops.image import build_pyramid

    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.randint(0, 256, shape, generator=g, device=dev).to(torch.float32)
    return build_pyramid(img, 4)


@pytest.mark.parametrize("fast_gate", [True, False])
@pytest.mark.parametrize("factor", [0.5, 1.0, 1.5])
def test_kernel_b_gate_equals_plain_gate(dev, kernels, fast_gate, factor):
    """Kernels A and B in both modes; with the FAST gate kernel B gates by
    the response gate it computes from the device threshold, which must
    equal the plain gate (fast.response_gate) at every threshold."""
    from rgbdslam_tpu_torch.ops import fast

    pyr = _pyramid(dev, 5)
    t = 20.0 * factor
    gate_thr = 20.0 if fast_gate else None
    ref = fast.detect_keypoints_ref(pyr, 1024, 16, t, 20.0, 16, fast_gate, gate_thr)
    for thr in (t, torch.full((), t, device=dev)):
        kp, _ = kernels.detect_keypoints_fused(pyr, 1024, 16, thr, 20.0, 16, fast_gate,
                                               gate_thr)
        for a, b in zip(kp, ref):
            assert torch.equal(a, b)
    gate = fast.response_gate(20.0, t, gate_thr)
    assert bool((ref.score[ref.valid] > gate).all())
    if fast_gate and factor != 1.0:
        assert gate != 20.0


def test_subpixel_refinement_card_matches_cpu(dev, kernels):
    from rgbdslam_tpu_torch.ops import fast

    pyr = _pyramid(dev, 9, (240, 320))
    for fast_gate in (True, False):
        kp = fast.detect_keypoints(pyr, 512, 8, 15.0, 20.0, 16, fast_gate, subpixel=True,
                                   gate_threshold=15.0 if fast_gate else None)
        cpu = fast.detect_keypoints([p.cpu() for p in pyr], 512, 8, 15.0, 20.0, 16, fast_gate,
                                    subpixel=True,
                                    gate_threshold=15.0 if fast_gate else None)
        _same_keypoints(kp, cpu)
        assert bool((kp.uv != kp.uv.round()).any())


def _same_keypoints(a, b):
    """Keypoints of a card build against the CPU's: levels and validity
    exact, integer positions exact and subpixel ones within 1e-4 px, scores
    within f32 rounding. The kernels equal the plain versions on the card
    bit for bit; the card's tensor code and the CPU's round the Shi-Tomasi
    arithmetic apart by ulps."""
    assert torch.equal(a.level.cpu(), b.level) and torch.equal(a.valid.cpu(), b.valid)
    torch.testing.assert_close(a.uv.cpu(), b.uv, rtol=0, atol=1e-4)
    assert torch.equal(a.uv.cpu().floor(), b.uv.floor())
    torch.testing.assert_close(a.score.cpu(), b.score, rtol=1e-5, atol=1e-3)


def _bits_held(a: np.ndarray, b: np.ndarray) -> float:
    x = np.unpackbits((a.view(np.uint32) ^ b.view(np.uint32)).view(np.uint8))
    return 1.0 - x.sum() / x.size


@pytest.mark.parametrize("variant", VARIANTS)
def test_family_build_card_matches_cpu(dev, kernels, tour_frames, variant):
    from rgbdslam_tpu_torch.config import ExtractorConfig
    from rgbdslam_tpu_torch.frontend.extractor import Extractor

    cam, frames = tour_frames
    ex = Extractor(cam, ExtractorConfig(num_features=512, cell_size=8, fast_threshold=15.0),
                   detector=variant)
    for gray, depth in frames:
        kernels.reset_launch_counts()
        fc = ex.build(gray.to(dev), depth.to(dev), 15.0)
        if variant == "orb":          # the x1.2 scale space: one detection, no dense K1
            assert kernels.LAUNCHES["detect_keypoints_scaled"] == 1
            assert kernels.LAUNCHES["detect_score_map"] == 0
        f = ex.build(gray, depth, 15.0)
        _same_keypoints(fc, f)
        a, b = fc.desc.cpu().numpy(), f.desc.numpy()
        if a.dtype == np.int32:
            assert _bits_held(a, b) >= 0.999
        else:
            flips = np.abs(a - b).max(axis=1) > 1e-5
            assert flips.mean() <= 0.01, flips.mean()
