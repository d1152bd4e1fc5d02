"""The multi-room world of rgbdslam_tpu_torch's renderer against
rgbdslam_tpu's: the figure-eight tour's poses are equal, depth agrees to f32
precision, and fewer than 0.3 % of a frame's pixels change texel (a hit
within an ulp of a texel edge rounds to the neighbouring texel when the ray
cast is fused differently; the bound of the box-room test in
tests/test_torch_frame.py).
"""

import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401
from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.io import synthetic as jsyn
from rgbdslam_tpu_torch.geometry.camera import Camera as TCamera
from rgbdslam_tpu_torch.io import synthetic as tsyn
from rgbdslam_tpu_torch.io.datasets import open_dataset
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM_ARGS = dict(fx=200.0, fy=200.0, cx=159.5, cy=119.5, width=320, height=240)


def test_multiroom_world_constants_match():
    np.testing.assert_array_equal(tsyn.MULTIROOM_BOXES, jsyn.MULTIROOM_BOXES)
    np.testing.assert_array_equal(np.float32(tsyn.MULTIROOM_HALF),
                                  np.asarray(jsyn.MULTIROOM_HALF))
    for n, loops in ((48, 1.0), (31, 1.3)):
        np.testing.assert_array_equal(tsyn.tour_trajectory(n, loops),
                                      jsyn.tour_trajectory(n, loops))


@pytest.mark.parametrize("index", [0, 5, 12, 17, 23])
def test_multiroom_renderer_matches_jax(index):
    dj = jsyn.SyntheticDataset(n_frames=24, cam=JCamera(**CAM_ARGS), trajectory="tour")
    dt = open_dataset("synthetic:tour", n_frames=24, cam=TCamera(**CAM_ARGS), device="cpu")
    np.testing.assert_array_equal(dt.poses_twc, dj.poses_twc)
    tj, gj, zj = dj.grab(index)
    tt, gt, zt = dt.grab(index)
    gj, zj, gt, zt = np.asarray(gj), np.asarray(zj), gt.numpy(), zt.numpy()
    assert tt == tj and gt.shape == (240, 320) and gt.dtype == np.float32
    np.testing.assert_allclose(zt, zj, rtol=1e-6, atol=1e-6)
    changed = np.abs(gt - gj) > 1e-3
    assert changed.mean() < 0.003, f"{changed.mean():.4%} of pixels changed texel"
    np.testing.assert_allclose(gt[~changed], gj[~changed], rtol=1e-5, atol=1e-3)


def test_tour_renders_occlusion():
    """The solids occlude: the tour has frames with strong depth steps and
    the boxes shorten the shell's depth somewhere."""
    cam = TCamera(**CAM_ARGS)
    ds = tsyn.SyntheticDataset(n_frames=24, cam=cam, trajectory="tour", device="cpu")
    max_jump, shorter = 0.0, False
    for i in range(0, 24, 6):
        _, _, depth = ds.grab(i)
        _, shell = tsyn.render_frame(cam, ds.poses_twc[i], room_half=tsyn.MULTIROOM_HALF,
                                     device="cpu")
        shorter |= bool((depth < shell - 0.1).any())
        assert bool((depth <= shell + 1e-5).all())
        max_jump = max(max_jump, float(np.abs(np.diff(depth.numpy(), axis=1)).max()))
    assert max_jump > 0.5 and shorter


def test_unknown_dataset_or_trajectory_raises():
    with pytest.raises(ValueError, match="unknown trajectory"):
        tsyn.SyntheticDataset(n_frames=4, trajectory="spiral", device="cpu")
    # a directory is a disk dataset since they were ported
    # (tests/test_torch_datasets.py): one without associations.txt raises
    with pytest.raises(FileNotFoundError, match="associations.txt"):
        open_dataset("/data/rgbd_dataset_freiburg1_xyz")


def test_entry_points_default_to_the_card():
    """render_frame, SyntheticDataset, LoopDetector, load_vocabulary and the
    convert module's *_from_numpy put what they make on the card unless the
    caller asks for the CPU: without a card the default raises, as the CLI
    and SlamSystem do; device="cpu" gives the CPU tensors of the same
    values."""
    from rgbdslam_tpu_torch import convert
    from rgbdslam_tpu_torch.config import LoopConfig
    from rgbdslam_tpu_torch.loop import vocabulary as tvoc
    from rgbdslam_tpu_torch.loop.detector import LoopDetector

    cam = TCamera(**CAM_ARGS)
    voc = tvoc.shipped_vocabulary("svo_fast")
    words = np.random.default_rng(0).integers(0, 2**32, (3, 8), dtype=np.uint64).astype(np.uint32)
    defaults = [
        lambda: tsyn.render_frame(cam, tsyn.tour_trajectory(4)[1]),
        lambda: tsyn.SyntheticDataset(n_frames=4, cam=cam, trajectory="tour"),
        lambda: LoopDetector(LoopConfig()),
        lambda: tvoc.load_vocabulary(voc),
        lambda: convert.desc_words_from_numpy(words),
        lambda: convert.vocabulary_from_numpy(words, np.ones(3, np.float32)),
        lambda: convert.pose_graph_edges_from_numpy([0], [1], np.eye(4)[None], [1.0]),
    ]
    if torch.cuda.is_available():
        assert tsyn.SyntheticDataset(n_frames=4, cam=cam).grab(1)[1].is_cuda
    else:
        for make in defaults:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    gray, depth = tsyn.render_frame(cam, tsyn.tour_trajectory(4)[1], device="cpu",
                                    room_half=tsyn.MULTIROOM_HALF, boxes=tsyn.MULTIROOM_BOXES)
    _, g_ds, d_ds = tsyn.SyntheticDataset(n_frames=4, cam=cam, trajectory="tour",
                                          device="cpu").grab(1)
    assert gray.device.type == "cpu" and torch.equal(g_ds, gray) and torch.equal(d_ds, depth)
    assert LoopDetector(LoopConfig(), device="cpu").device == torch.device("cpu")
    w, idf = tvoc.load_vocabulary(voc, device="cpu")
    with np.load(voc) as d:
        np.testing.assert_array_equal(w.numpy().view(np.uint32), d["words"])
        np.testing.assert_array_equal(idf.numpy(), d["idf"])
    t = convert.desc_words_from_numpy(words, device="cpu")
    assert t.device.type == "cpu" and np.array_equal(t.numpy().view(np.uint32), words)
