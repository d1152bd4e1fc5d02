"""K1 as the whole x1.2 scale-space detection (kernels A and C of
csrc/detect.cu) and the subpixel offsets of kernel A's table, on the card,
against their plain versions. Every test here is marked `gpu` and skips
without a card:

  python -m pytest --noconftest -m gpu tests/test_torch_gpu_scale_detect.py

Tolerances: exact. The kernels are built with -fmad=false and written in
the plain versions' operation order, so kernel A's cell maxima, arguments
and offsets, kernel C's slots (uv, level, score, valid) and the half-sample
detection with offsets equal the plain versions bit for bit.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def kernels(dev):
    from rgbdslam_tpu_torch.ops import kernels as k

    return k


def _image(dev, kind, shape, seed):
    """A rendered tour frame, an integer image, or one of four grey values
    (equal scores inside a cell and across cells)."""
    from rgbdslam_tpu_torch.geometry.camera import Camera
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset

    h, w = shape
    if kind == "rendered":
        cam = Camera(0.9 * w, 0.9 * w, (w - 1) / 2, (h - 1) / 2, width=w, height=h)
        ds = SyntheticDataset(n_frames=128, cam=cam, trajectory="tour", loops=1.15, device=dev)
        return ds.grab(seed)[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    step = 1 if kind == "integer" else 64
    return (torch.randint(0, 256 // step, shape, generator=g, device=dev) * step
            ).to(torch.float32)


def _same(a, b):
    for f in ("uv", "level", "score", "valid"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), f


def _hold_scaled(kernels, pyr, quotas, cell, thr, border, fast_gate, gate_thr, subpixel):
    """Kernel A against the plain per-level cells, kernel C against the plain
    ranking on kernel A's outputs, the whole against the whole: exact."""
    from rgbdslam_tpu_torch.ops import fast

    shapes = [tuple(p.shape) for p in pyr]
    kernels.reset_launch_counts()
    kp, (cmax, carg, coff) = kernels.detect_keypoints_scaled(pyr, quotas, cell, thr, 20.0,
                                                             border, fast_gate, gate_thr,
                                                             subpixel)
    assert kernels.LAUNCHES["detect_keypoints_scaled"] == 1
    assert kernels.LAUNCHES["detect_score_map"] == 0
    pmax, parg, poff = fast.detect_scaled_cells_ref(pyr, quotas, cell, thr, border, fast_gate,
                                                    subpixel)
    assert torch.equal(cmax, pmax) and torch.equal(carg, parg)
    if subpixel:
        assert torch.equal(coff, poff)
    else:
        assert coff is None and poff is None
    gate = fast.response_gate(20.0, thr, gate_thr)
    _same(kp, fast.detect_scaled_select_ref(cmax, carg, coff, shapes, quotas, cell, gate))
    _same(kp, fast.detect_keypoints_scaled_ref(pyr, quotas, cell, thr, 20.0, border, fast_gate,
                                               gate_thr, subpixel))
    _same(kp, fast.detect_keypoints_scaled(pyr, quotas, cell, thr, 20.0, border, fast_gate,
                                           gate_thr, subpixel))
    return kp


@pytest.mark.parametrize("kind,shape,cell,n_slots",
                         [("rendered", (480, 640), 16, 1024), ("integer", (480, 640), 16, 1024),
                          ("coarse", (240, 320), 8, 512), ("rendered", (120, 160), 8, 1024)])
@pytest.mark.parametrize("fast_gate", [True, False])
@pytest.mark.parametrize("subpixel", [False, True])
def test_scaled_detection_matches_plain(dev, kernels, kind, shape, cell, n_slots, fast_gate,
                                        subpixel):
    """Kernel A's x1.2 mode, its offsets and kernel C on the 8 levels of the
    x1.2 pyramid (ragged level sizes: 533, 444, 370, ... pixels wide), at a
    float and at a device threshold, FAST-gated and in the GFTT mode; at
    160x120 the quota of level 0 exceeds its cells."""
    from rgbdslam_tpu_torch.ops import fast, image

    pyr = image.build_scaled_pyramid(_image(dev, kind, shape, 40), 8, 1.2)
    quotas = fast.level_quotas(n_slots, 8, 1.2, cell, [tuple(p.shape) for p in pyr])
    gate_thr = 20.0 if fast_gate else None
    for thr in (20.0, torch.full((), 20.0, device=dev)):
        kp = _hold_scaled(kernels, pyr, quotas, cell, thr, 16, fast_gate, gate_thr, subpixel)
        assert int(kp.valid.sum()) > 50
    assert bool((kp.uv != kp.uv.round()).any()) == subpixel


@pytest.mark.parametrize("factor", [0.5, 1.0, 2.0])
def test_scaled_gate_from_the_device_threshold(dev, kernels, factor):
    """Kernel C gates by (thr * thr) * K from the device threshold (F6):
    equal to the plain gate at 0.5x, 1x and 2x the configured threshold; a
    threshold rewritten on the device is read there."""
    from rgbdslam_tpu_torch.ops import fast, image

    pyr = image.build_scaled_pyramid(_image(dev, "rendered", (480, 640), 75), 8, 1.2)
    quotas = fast.level_quotas(1024, 8, 1.2, 16, [tuple(p.shape) for p in pyr])
    t = 20.0 * factor
    kp = _hold_scaled(kernels, pyr, quotas, 16, t, 16, True, 20.0, False)
    thr = torch.full((), 1.0, device=dev)
    thr.fill_(t)
    _same(kp, kernels.detect_keypoints_scaled(pyr, quotas, 16, thr, 20.0, 16, True, 20.0)[0])
    assert bool((kp.score[kp.valid] > fast.response_gate(20.0, t, 20.0)).all())


def test_scaled_odd_quotas(dev, kernels):
    """A level with quota 0 is not read and has no slots; a level smaller
    than a cell pads all of its slots; ragged sizes leave pixels that belong
    to no cell."""
    from rgbdslam_tpu_torch.ops import image

    pyr = image.build_scaled_pyramid(_image(dev, "integer", (96, 128), 5), 8, 1.2)
    pyr = pyr[:7] + [pyr[7][:10, :12].contiguous()]
    quotas = [200, 0, 30, 20, 10, 5, 3, 4]
    kp = _hold_scaled(kernels, pyr, quotas, 16, 15.0, 8, True, 15.0, True)
    assert kp.uv.shape == (272, 2) and 1 not in kp.level.tolist()
    assert not bool(kp.valid[-4:].any()) and float(kp.uv[-4:].abs().sum()) == 0.0
    assert kp.level[-4:].tolist() == [7] * 4


@pytest.mark.parametrize("kind", ["rendered", "integer", "coarse"])
@pytest.mark.parametrize("fast_gate", [True, False])
def test_half_sample_subpixel_matches_plain(dev, kernels, kind, fast_gate):
    """Kernels A and B with the offsets of kernel A's table: the offsets,
    the cell winners and the slots equal the plain versions; the slots
    whose cell has no corner move by the offsets of pixel (0, 0) of level 0.
    No dense K1 is launched."""
    from rgbdslam_tpu_torch.ops import fast, image

    img = _image(dev, kind, (240, 320), 11)
    img[:, :96] = 100.0                               # cells without a corner
    pyr = image.build_pyramid(img, 4)
    gate_thr = 15.0 if fast_gate else None
    kernels.reset_launch_counts()
    kp, (cmax, carg, coff) = kernels.detect_keypoints_fused(pyr, 1024, 8, 15.0, 20.0, 8,
                                                            fast_gate, gate_thr, True)
    pmax, parg, poff = fast.detect_cells_ref(pyr, 8, 15.0, 8, fast_gate, True)
    assert torch.equal(cmax, pmax) and torch.equal(carg, parg) and torch.equal(coff, poff)
    gate = fast.response_gate(20.0, 15.0, gate_thr)
    _same(kp, fast.detect_select_ref(cmax, carg, 40, 1024, 8, gate, coff))
    _same(kp, fast.detect_keypoints_ref(pyr, 1024, 8, 15.0, 20.0, 8, fast_gate, gate_thr,
                                        True))
    _same(kp, fast.detect_keypoints(pyr, 1024, 8, 15.0, 20.0, 8, fast_gate, True,
                                    gate_threshold=gate_thr))
    assert kernels.LAUNCHES["detect_keypoints_fused"] == 2
    assert kernels.LAUNCHES["detect_score_map"] == 0
    n_cells = 30 * 40
    assert not bool(kp.valid[:n_cells].all())        # slots of cells with no corner


@pytest.mark.parametrize("detector,subpixel", [("orb", False), ("orb", True),
                                               ("gftt", False), ("svo_fast", True)])
def test_builds_launch_no_dense_kernel(dev, kernels, detector, subpixel):
    """An ORB build's detection is one x1.2 detection (two launches), a
    subpixel build's one half-sample detection; neither launches the dense
    K1, and each equals the CPU build's keypoints."""
    import dataclasses

    from rgbdslam_tpu_torch.config import ExtractorConfig
    from rgbdslam_tpu_torch.frontend.extractor import Extractor
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset

    ds = SyntheticDataset(n_frames=128, cam=SYNTHETIC, trajectory="tour", loops=1.15,
                          device="cpu")
    _, gray, depth = ds.grab(50)
    ex = Extractor(SYNTHETIC, dataclasses.replace(ExtractorConfig(), subpixel=subpixel),
                   detector=detector)
    kernels.reset_launch_counts()
    fc = ex.build(gray.to(dev), depth.to(dev), 20.0)
    scaled = detector == "orb"
    assert kernels.LAUNCHES["detect_keypoints_scaled"] == int(scaled)
    assert kernels.LAUNCHES["detect_keypoints_fused"] == int(not scaled)
    assert kernels.LAUNCHES["detect_score_map"] == 0
    f = ex.build(gray, depth, 20.0)
    assert torch.equal(fc.level.cpu(), f.level) and torch.equal(fc.valid.cpu(), f.valid)
    assert torch.equal(fc.uv.cpu().floor(), f.uv.floor())
    torch.testing.assert_close(fc.uv.cpu(), f.uv, rtol=0, atol=1e-4)
    torch.testing.assert_close(fc.score.cpu(), f.score, rtol=1e-5, atol=1e-3)
