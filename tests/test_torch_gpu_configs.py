"""The configurations that need the kernel modes added for them, on the card,
against the plain versions: kernel A of csrc/detect.cu at any cell size
(tiles of whole cells, a block a cell past 32 pixels), any number of
levels, kernels B and C past the cells their shared memory holds, K4 past the 3,000 points its shared memory holds and
with nearest-neighbour reassociation, and the fused RANSAC at any sample
size, under every error model, with the Mahalanobis polish and past the
correspondences kernel B's shared memory holds. Every test here is marked
`gpu` and skips without a card:

  python -m pytest --noconftest -m gpu tests/test_torch_gpu_configs.py

Each kernel mode runs through its public entry with the plain versions made
to raise (`forbid`), after the plain result was computed. Launches are the
wrappers' counts (the detections two kernels a call, K4 one, the RANSAC two
after its draws); chip_smoke.py counts the device's with the profiler.
Tolerances, each with its reason:
- the detections: exact (-fmad=false, the plain versions' operation order);
- K4: the pose rtol 1e-4 / atol 1e-5 and converged / n_valid exact, the
  bound tests/test_torch_gpu.py holds the loop to (sums in another order);
- RANSAC: kernel A's counts exact against the plain scoring of its own
  poses, its poses atol 5e-5 (30 power iterations summed in another order);
  the whole: success equal, inlier count within 2, T21 rtol 1e-4 / atol
  5e-5 (a correspondence on the threshold may change sides when the refits
  sum in another order), with and without the polish (the bound the CPU
  tests hold the polish to against the JAX package). Where the plain
  polish moves a pose by more than 1e-4, the kernel's pose lies within a
  quarter of that move of the polished pose, so a kernel B that skipped
  the polish fails.
"""

import contextlib

import numpy as np
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


@contextlib.contextmanager
def forbid(monkeypatch):
    """Every plain version of a kernel raises inside the block."""
    from rgbdslam_tpu_torch.ops import fast
    from rgbdslam_tpu_torch.ops import kernels as k
    from rgbdslam_tpu_torch.solvers import icp
    from rgbdslam_tpu_torch.solvers import ransac_se3 as rs

    def raiser(*a, **kw):
        raise AssertionError("plain version ran for CUDA tensors")

    with monkeypatch.context() as m:
        for mod, names in ((k, ("detect_score_map_ref", "mahal_hypothesis_scores_ref",
                                "gicp_refine_ref")),
                           (fast, ("detect_keypoints_ref", "detect_cells_ref",
                                   "detect_select_ref", "detect_keypoints_scaled_ref",
                                   "detect_scaled_cells_ref")),
                           (icp, ("_finish_gicp", "nearest_targets")),
                           (rs, ("ransac_se3_ref", "hypotheses_ref", "select_refine_ref",
                                 "refine_mahalanobis_ref", "pair_errors"))):
            for n in names:
                m.setattr(mod, n, raiser, raising=False)
        yield


# ---------------------------------------------------------------------------
# kernel A at any cell size
# ---------------------------------------------------------------------------


def _frame(dev, h=480, w=640, seed=9):
    from rgbdslam_tpu_torch.geometry.camera import Camera
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset

    cam = Camera(0.9 * w, 0.9 * w, (w - 1) / 2, (h - 1) / 2, width=w, height=h)
    return SyntheticDataset(n_frames=128, cam=cam, trajectory="tour", loops=1.15,
                            device=dev).grab(seed)[1]


def _same(a, b):
    for f in ("uv", "level", "score", "valid"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), f


CELLS = [3, 5, 6, 10, 12, 24]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("subpixel", [False, True])
def test_half_sample_detection_any_cell(dev, kernels, monkeypatch, cell, subpixel):
    """Kernel A's whole-cell tiles on every level of the half-sample pyramid
    (cell_size >> level pixels: 3 -> 3, 1; 24 -> 24, 12, 6, 3), against the
    plain cells and the whole plain detection, exactly."""
    from rgbdslam_tpu_torch.ops import fast, image

    pyr = image.build_pyramid(_frame(dev), 4)
    kw = dict(num_features=1024, cell_size=cell, fast_threshold=20.0, min_response=20.0,
              min_border=16, subpixel=subpixel)
    cells = fast.detect_cells_ref(pyr, cell, 20.0, 16, True, subpixel)
    ref = fast.detect_keypoints_ref(pyr, **kw)
    with forbid(monkeypatch):
        kernels.reset_launch_counts()
        kp, kcells = kernels.detect_keypoints_fused(pyr, 1024, cell, 20.0, 20.0, 16,
                                                    subpixel=subpixel)
        for a, b in zip(kcells, cells):
            assert torch.equal(a, b)
        _same(kp, ref)
        _same(fast.detect_keypoints(pyr, **kw), ref)
        assert kernels.LAUNCHES["detect_keypoints_fused"] == 2
        assert kernels.LAUNCHES["detect_score_map"] == 0
    assert int(ref.valid.sum()) > 100


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("subpixel", [False, True])
def test_scaled_detection_any_cell(dev, kernels, monkeypatch, cell, subpixel):
    """Kernel A's x1.2 mode (cell_size on every level's own grid) and
    kernel C at any cell size, against the plain versions, exactly."""
    from rgbdslam_tpu_torch.ops import fast, image

    pyr = image.build_scaled_pyramid(_frame(dev, seed=40), 8, 1.2)
    quotas = fast.level_quotas(1024, 8, 1.2, cell, [tuple(p.shape) for p in pyr])
    args = (pyr, quotas, cell, 20.0, 20.0, 16, True, 20.0, subpixel)
    pmax, parg, poff = fast.detect_scaled_cells_ref(pyr, quotas, cell, 20.0, 16, True,
                                                    subpixel)
    ref = fast.detect_keypoints_scaled_ref(*args)
    with forbid(monkeypatch):
        kernels.reset_launch_counts()
        kp, (cmax, carg, coff) = kernels.detect_keypoints_scaled(*args)
        assert torch.equal(cmax, pmax) and torch.equal(carg, parg)
        assert (coff is None and poff is None) or torch.equal(coff, poff)
        _same(kp, ref)
        _same(fast.detect_keypoints_scaled(*args), ref)
        assert kernels.LAUNCHES["detect_keypoints_scaled"] == 2
        assert kernels.LAUNCHES["detect_score_map"] == 0
    assert int(ref.valid.sum()) > 100


@pytest.mark.parametrize("cell", [7, 17, 31, 32, 33])
def test_detection_odd_and_widest_cells(dev, kernels, cell):
    """Cells that fill one tile (17-32: 32 x 32 at most, two pixels a
    thread), a prime cell and the narrowest cell a block walks in sub-tiles
    (33: a 32 x 16 sub-tile and 1-pixel slivers), on an integer image whose
    levels are no whole number of tiles."""
    from rgbdslam_tpu_torch.ops import fast, image

    g = torch.Generator(device=dev).manual_seed(cell)
    img = torch.randint(0, 256, (235, 301), generator=g, device=dev).to(torch.float32)
    pyr = image.build_pyramid(img, 3)
    for sub in (False, True):
        kw = dict(num_features=300, cell_size=cell, fast_threshold=20.0, min_response=20.0,
                  min_border=5, subpixel=sub)
        _same(kernels.detect_keypoints_fused(pyr, **kw)[0],
              fast.detect_keypoints_ref(pyr, **kw))


WIDE = [33, 40, 64]


@pytest.mark.parametrize("cell", WIDE)
@pytest.mark.parametrize("subpixel", [False, True])
def test_half_sample_detection_wide_cells(dev, kernels, monkeypatch, cell, subpixel):
    """Cells wider than a tile at 640x480: kernel A gives a block to each
    cell of the upper levels (40 -> 40 on level 0, then 20, 10, 5 in tiles
    of whole cells; 64 -> 64, 32, 16, 8), the cells, offsets and keypoints
    equal to the plain version's exactly, two launches a detection."""
    from rgbdslam_tpu_torch.ops import fast, image

    pyr = image.build_pyramid(_frame(dev), 4)
    kw = dict(num_features=1024, cell_size=cell, fast_threshold=20.0, min_response=20.0,
              min_border=16, subpixel=subpixel)
    cells = fast.detect_cells_ref(pyr, cell, 20.0, 16, True, subpixel)
    ref = fast.detect_keypoints_ref(pyr, **kw)
    with forbid(monkeypatch):
        kernels.reset_launch_counts()
        kp, kcells = kernels.detect_keypoints_fused(pyr, 1024, cell, 20.0, 20.0, 16,
                                                    subpixel=subpixel)
        for a, b in zip(kcells, cells):
            assert torch.equal(a, b)
        _same(kp, ref)
        _same(fast.detect_keypoints(pyr, **kw), ref)
        assert kernels.LAUNCHES["detect_keypoints_fused"] == 2
    n_cells = (480 // cell) * (640 // cell)
    assert int(ref.valid.sum()) > n_cells // 2


@pytest.mark.parametrize("cell,levels", [(33, 8), (40, 8), (64, 8), (16, 9), (16, 12),
                                         (40, 12), (8, 40)])
@pytest.mark.parametrize("subpixel", [False, True])
def test_scaled_detection_wide_cells_and_many_levels(dev, kernels, monkeypatch, cell, levels,
                                                     subpixel):
    """The x1.2 detection at cells wider than a tile (a block a cell on
    every level), at 9 and 12 levels, at 12 levels of cells of 40 (whose
    smallest levels hold one cell) and at 40 levels (two groups of kernel
    A and C launches; the 16-pixel floor of the last levels), against the
    plain versions, exactly."""
    from rgbdslam_tpu_torch.ops import fast, image

    pyr = image.build_scaled_pyramid(_frame(dev, seed=40), levels, 1.2)
    quotas = fast.level_quotas(1024, levels, 1.2, cell, [tuple(p.shape) for p in pyr])
    args = (pyr, quotas, cell, 20.0, 20.0, 16, True, 20.0, subpixel)
    pmax, parg, poff = fast.detect_scaled_cells_ref(pyr, quotas, cell, 20.0, 16, True,
                                                    subpixel)
    ref = fast.detect_keypoints_scaled_ref(*args)
    with forbid(monkeypatch):
        kp, (cmax, carg, coff) = kernels.detect_keypoints_scaled(*args)
        assert torch.equal(cmax, pmax) and torch.equal(carg, parg)
        assert (coff is None and poff is None) or torch.equal(coff, poff)
        _same(kp, ref)
    assert int(ref.valid.sum()) > 100
    assert int(kp.level.max()) == max(lvl for lvl, q in enumerate(quotas) if q > 0)


@pytest.mark.parametrize("h,w,cell", [(480, 640, 2), (240, 320, 1), (1080, 1920, 6),
                                      (1080, 1920, 5)])
def test_detection_past_shared_memory(dev, kernels, monkeypatch, h, w, cell):
    """76,800 cells (cells of 2 at 640x480, of 1 at 320x240) and 82,944
    (cells of 5 at 1920x1080): kernel B streams the gated scores through
    chunks, kernel C (the x1.2 detection at the same cell) a level's maxima
    where the level holds more than shared memory (58,112 cells); 57,600
    (cells of 6 at 1920x1080) is the largest grid of these that a block
    stages whole (230 KB). The ranking, ties included, equals the plain
    stable sort's."""
    from rgbdslam_tpu_torch.ops import fast, image

    gray = _frame(dev, h, w, seed=20)
    assert (h // cell) * (w // cell) > 46000
    pyr = image.build_pyramid(gray, 3)
    kw = dict(num_features=4096, cell_size=cell, fast_threshold=20.0, min_response=20.0,
              min_border=16)
    cells = fast.detect_cells_ref(pyr, cell, 20.0, 16)
    ref = fast.detect_keypoints_ref(pyr, **kw)
    x12 = image.build_scaled_pyramid(gray, 8, 1.2)
    quotas = fast.level_quotas(4096, 8, 1.2, cell, [tuple(p.shape) for p in x12])
    args = (x12, quotas, cell, 20.0, 20.0, 16, True, 20.0)
    ref12 = fast.detect_keypoints_scaled_ref(*args)
    with forbid(monkeypatch):
        kp, kcells = kernels.detect_keypoints_fused(pyr, **kw)
        for a, b in zip(kcells, cells):
            assert torch.equal(a, b)
        _same(kp, ref)
        _same(kernels.detect_keypoints_scaled(*args)[0], ref12)
    assert int(ref.valid.sum()) > 500 and int(ref12.valid.sum()) > 500


# ---------------------------------------------------------------------------
# K4 past its shared memory, and reassociating
# ---------------------------------------------------------------------------


def _gicp_problem(dev, seed, N=1024, swap=0.0):
    """A GICP problem with SPD covariances; `swap` of the valid pairs get a
    wrong partner (a rotation of their targets), as wrong descriptor matches
    do."""
    from rgbdslam_tpu_torch.geometry import se3

    g = torch.Generator(device=dev).manual_seed(seed)
    p1 = torch.rand(N, 3, generator=g, device=dev) * 2 - 1
    p1[:, 2] += 2.5
    T = se3.exp(0.03 * torch.randn(6, generator=g, device=dev))
    p2 = p1 @ T[:3, :3].T + T[:3, 3] + 0.004 * torch.randn(N, 3, generator=g, device=dev)
    A = 0.02 * torch.randn(N, 3, 3, generator=g, device=dev)
    C1 = (A @ A.transpose(1, 2) + 1e-4 * torch.eye(3, device=dev)).contiguous()
    C2 = C1.flip(0).contiguous()
    valid = torch.rand(N, generator=g, device=dev) > 0.2
    if swap:
        k = int(swap * N)
        p2[:k] = p2[:k].roll(1, 0)
    T0 = (se3.exp(0.02 * torch.randn(6, generator=g, device=dev)) @ T).contiguous()
    return T0, p1, p2.contiguous(), C1, C2, valid


def _plain_gicp(kernels, args, reassociate, min_matches=20):
    from rgbdslam_tpu_torch.config import IcpConfig
    from rgbdslam_tpu_torch.solvers.icp import _finish_gicp

    T0, p1, p2, C1, C2, valid = args
    T_fin, _, _ = kernels.gicp_refine_ref(*args, 10, 0.07, reassociate=reassociate)
    cfg = IcpConfig(max_iterations=10, max_correspondence_dist=0.07, min_matches=min_matches,
                    reassociate=reassociate)
    return _finish_gicp(T_fin, T0, p1, p2, valid, cfg), T_fin


@pytest.mark.parametrize("n", [3000, 3001, 4096])
@pytest.mark.parametrize("reassociate", [False, True])
def test_gicp_refine_any_size_and_reassociating(dev, kernels, monkeypatch, n, reassociate):
    """K4 with its planes in shared memory (3,000) and in global memory
    (3,001, 4,096), with and without reassociation, against the plain loop
    and gate; one launch and one device kernel a call; the same bits
    twice."""
    from rgbdslam_tpu_torch.config import IcpConfig
    from rgbdslam_tpu_torch.solvers import icp

    args = _gicp_problem(dev, 50 + n, n, swap=0.1 if reassociate else 0.0)
    (pT, pconv, pnv), pfin = _plain_gicp(kernels, args, reassociate)
    T0, p1, p2, C1, C2, valid = args
    cfg = IcpConfig(max_iterations=10, max_correspondence_dist=0.07, reassociate=reassociate)
    with forbid(monkeypatch):
        kernels.reset_launch_counts()
        (kT, kconv, knv), (kfin, _, _) = kernels.gicp_refine_fused(
            *args, 10, 0.07, 20, reassociate=reassociate)
        assert kernels.LAUNCHES["gicp_refine_fused"] == 1
        assert bool(kconv) == bool(pconv) and int(knv) == int(pnv)
        torch.testing.assert_close(kfin, pfin, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(kT, pT, rtol=1e-4, atol=1e-5)
        again = icp.gicp_refine(p1, p2, valid, T0, cfg, C1, C2)
        assert torch.equal(again[0], kT)
        assert kernels.LAUNCHES["gicp_refine_fused"] == 2
    assert bool(kconv)


def test_gicp_padding_to_global_memory_moves_nothing(dev, kernels):
    """A 3,000-point problem padded with invalid slots up to 4,096 runs from
    global memory and gives T_out within 1e-6 of the shared-memory run."""
    args = _gicp_problem(dev, 77, 3000)
    (kT, kconv, knv), _ = kernels.gicp_refine_fused(*args, 10, 0.07, 20)
    pad = 4096 - 3000
    T0, p1, p2, C1, C2, valid = args
    padded = (T0, torch.cat([p1, p1[:pad]]), torch.cat([p2, p2[:pad]]),
              torch.cat([C1, C1[:pad]]).contiguous(), torch.cat([C2, C2[:pad]]).contiguous(),
              torch.cat([valid, torch.zeros(pad, dtype=torch.bool, device=dev)]))
    (gT, gconv, gnv), _ = kernels.gicp_refine_fused(*padded, 10, 0.07, 20)
    assert bool(gconv) == bool(kconv) and int(gnv) == int(knv)
    assert float((gT - kT).abs().max()) <= 1e-6


def test_gicp_reassociation_recovers_bad_pairings(dev, kernels):
    """With a third of the pairs wrong the descriptor pairing leaves the
    pose off; re-pairing to the nearest target recovers it (the behaviour
    tests/test_pnp_icp.py holds the JAX package to)."""
    from rgbdslam_tpu_torch.config import IcpConfig
    from rgbdslam_tpu_torch.geometry import se3
    from rgbdslam_tpu_torch.solvers import icp

    g = torch.Generator(device=dev).manual_seed(5)
    N = 512
    p1 = torch.rand(N, 3, generator=g, device=dev) * 2 - 1
    p1[:, 2] += 2.5
    T = se3.exp(torch.tensor([0.01, -0.01, 0.02, 0.01, 0.01, -0.005], device=dev))
    p2 = p1 @ T[:3, :3].T + T[:3, 3]
    bad = p2.clone()
    bad[: N // 3] = bad[: N // 3].roll(1, 0)
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    eye = torch.eye(4, device=dev)
    cfg = IcpConfig(max_correspondence_dist=0.5, reassociate=True)
    Tr, conv, _ = icp.gicp_refine(p1, bad.contiguous(), valid, eye, cfg)
    assert bool(conv)
    assert float((Tr - T).abs().max()) < 5e-3


# ---------------------------------------------------------------------------
# the fused RANSAC: any S, every error model, the polish, N = 8,192
# ---------------------------------------------------------------------------


def _ransac_problem(dev, seed, lead=(), N=1024, outliers=0.3, p_valid=0.85):
    from rgbdslam_tpu_torch.frontend.matcher import correspondence_weights
    from rgbdslam_tpu_torch.geometry import se3

    g = torch.Generator(device=dev).manual_seed(seed)
    p1 = torch.rand(lead + (N, 3), generator=g, device=dev) * 2 - 1
    p1[..., 2] += 2.5
    T = se3.exp(0.05 * torch.randn(lead + (6,), generator=g, device=dev))
    p2 = (p1 @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
          + 0.003 * torch.randn(lead + (N, 3), generator=g, device=dev))
    bad = torch.rand(lead + (N,), generator=g, device=dev) < outliers
    p2 = p2 + bad[..., None] * 0.5 * torch.randn(lead + (N, 3), generator=g, device=dev)
    valid = torch.rand(lead + (N,), generator=g, device=dev) < p_valid
    w = correspondence_weights(p1, p2, valid)
    return p1.contiguous(), p2.contiguous(), w, valid, g


def _cam():
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC

    return SYNTHETIC


def _hold_ransac(monkeypatch, p1, p2, w, valid, cfg, draws, cam=None):
    """The fused RANSAC against the plain one: kernel A's poses and its
    counts on its own poses, kernel B and the whole; then ransac_se3 on the
    card with the plain versions forbidden gives the same bits."""
    from rgbdslam_tpu_torch.ops import kernels
    from rgbdslam_tpu_torch.solvers import ransac_se3 as rs

    pT_h, pcnt, perr = rs.hypotheses_ref(p1, p2, w, valid, cfg, draws=draws, cam=cam)
    res, (T_h, cnt_h, err_h) = rs.ransac_se3_cuda(p1, p2, w, valid, cfg, draws=draws, cam=cam)
    ok = ~(torch.isnan(T_h) & torch.isnan(pT_h))
    assert float((T_h - pT_h).abs()[ok].max()) <= 5e-5
    own_ok, own_err = rs.pair_errors(T_h, p1, p2, cfg, cam)
    inl = own_ok & valid[..., None, :]
    assert torch.equal(cnt_h, inl.sum(-1).to(torch.int32))
    torch.testing.assert_close(err_h, torch.where(inl, own_err, 0.0).sum(-1),
                               rtol=1e-5, atol=1e-4)
    for ref in (rs.select_refine_ref(T_h, cnt_h, err_h, p1, p2, w, valid, cfg, cam),
                rs.select_refine_ref(pT_h, pcnt, perr, p1, p2, w, valid, cfg, cam)):
        assert torch.equal(res.success, ref.success)
        assert int((res.num_inliers.long() - ref.num_inliers.long()).abs().max()) <= 2
        torch.testing.assert_close(res.T21, ref.T21, rtol=1e-4, atol=5e-5)
    with forbid(monkeypatch):
        kernels.reset_launch_counts()
        again = rs.ransac_se3(p1, p2, w, valid, None, cfg, draws=draws, cam=cam)
        assert kernels.LAUNCHES["ransac_se3_fused"] == 1
        assert torch.equal(again.T21, res.T21) and torch.equal(again.inliers, res.inliers)
    return res


def _draws(g, valid, H, S):
    nv = torch.clamp_min(valid.sum(-1), 1)
    u = torch.rand(valid.shape[:-1] + (H, S), generator=g, device=valid.device)
    return torch.minimum((u * nv[..., None, None]).long(), nv[..., None, None] - 1)


@pytest.mark.parametrize("S", [3, 5, 8])
def test_ransac_any_sample_size(dev, monkeypatch, S):
    from rgbdslam_tpu_torch.config import RansacConfig

    p1, p2, w, valid, g = _ransac_problem(dev, 10 + S)
    cfg = RansacConfig(sample_size=S)
    res = _hold_ransac(monkeypatch, p1, p2, w, valid, cfg, _draws(g, valid, 256, S))
    assert bool(res.success) and int(res.num_inliers) > 400


@pytest.mark.parametrize("model", ["euclidean", "adaptive_euclidean", "reprojection", "both"])
@pytest.mark.parametrize("lead", [(), (13,)])
def test_ransac_error_models(dev, monkeypatch, model, lead):
    from rgbdslam_tpu_torch.config import RansacConfig
    from rgbdslam_tpu_torch.solvers import ransac_se3 as rs

    p1, p2, w, valid, g = _ransac_problem(dev, 20, lead)
    if lead:
        valid[4] = False
        valid[9] = False
    cfg = RansacConfig(error_model=model)
    cam = _cam() if model in ("reprojection", "both") else None
    res = _hold_ransac(monkeypatch, p1, p2, w, valid, cfg, _draws(g, valid, 256, 4), cam)
    if lead:
        assert res.success.tolist() == [i not in (4, 9) for i in range(13)]
    else:
        assert bool(res.success)
    if cam is not None:
        with pytest.raises(ValueError, match="camera"):
            rs.ransac_se3(p1, p2, w, valid, g, cfg)


def _polish_moves(res, p1, p2, w, valid, cfg, draws):
    """How far the plain polish moves each pose (its result against the
    unpolished result of the same draws), and the kernel's pose's distance
    from the polished pose; asserts the kernel's pose lies by the polished
    one wherever the polish moved it by more than 1e-4."""
    import dataclasses

    from rgbdslam_tpu_torch.solvers import ransac_se3 as rs

    hyp = rs.hypotheses_ref(p1, p2, w, valid, cfg, draws=draws)
    polished = rs.select_refine_ref(*hyp, p1, p2, w, valid, cfg)
    bare = rs.select_refine_ref(*hyp, p1, p2, w, valid,
                                dataclasses.replace(cfg, mahalanobis_refine=False))
    move = (polished.T21 - bare.T21).abs().amax((-1, -2))
    off = (res.T21 - polished.T21).abs().amax((-1, -2))
    kept = move > 1e-4
    assert bool((off[kept] < 0.25 * move[kept]).all()), (move, off)
    return kept


@pytest.mark.parametrize("lead", [(), (13,)])
def test_ransac_mahalanobis_polish(dev, monkeypatch, lead):
    from rgbdslam_tpu_torch.config import RansacConfig

    p1, p2, w, valid, g = _ransac_problem(dev, 30, lead)
    cfg = RansacConfig(mahalanobis_refine=True)
    draws = _draws(g, valid, 256, 4)
    res = _hold_ransac(monkeypatch, p1, p2, w, valid, cfg, draws)
    assert bool(res.success.all())
    kept = _polish_moves(res, p1, p2, w, valid, cfg, draws)
    if lead:
        # the polish moves most of the 13 poses on this problem
        assert int(kept.sum()) >= 4


@pytest.mark.parametrize("model,polish", [("mahalanobis", False), ("mahalanobis", True),
                                          ("euclidean", False)])
def test_ransac_past_shared_memory(dev, kernels, monkeypatch, model, polish):
    """N = 8,192 (kernel B's planes in global memory) against the plain
    version; a batch of 3 at that size too."""
    from rgbdslam_tpu_torch.config import RansacConfig

    assert kernels.select_scratch_stride(8192) > 0 and kernels.select_scratch_stride(1024) == 0
    cfg = RansacConfig(error_model=model, mahalanobis_refine=polish)
    for lead in ((), (3,)):
        p1, p2, w, valid, g = _ransac_problem(dev, 40, lead, N=8192)
        draws = _draws(g, valid, 256, 4)
        res = _hold_ransac(monkeypatch, p1, p2, w, valid, cfg, draws)
        assert bool(res.success.all())
        if polish:
            _polish_moves(res, p1, p2, w, valid, cfg, draws)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


def _tour_frames(dev, n):
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset

    ds = SyntheticDataset(n_frames=128, cam=SYNTHETIC, trajectory="tour", device=dev)
    return ds, [ds.grab(i) for i in range(n)]


@pytest.mark.parametrize("num_features,cell", [(4096, 8), (1024, 6)])
def test_slam_system_tracks_new_configs(dev, kernels, monkeypatch, num_features, cell):
    """SlamSystem.track on 24 tour frames at num_features=4096 / cell 8 and
    at cell 6: finite poses, no failed frame, one K4 launch an estimate."""
    from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, SlamConfig
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC
    from rgbdslam_tpu_torch.slam.system import SlamSystem

    cfg = SlamConfig(extractor=ExtractorConfig(num_features=num_features, cell_size=cell),
                     loop=LoopConfig(id_interval=12, min_kfs_since_loop=10))
    system = SlamSystem(SYNTHETIC, cfg, seed=0, device=dev)
    _, frames = _tour_frames(dev, 24)
    with forbid(monkeypatch):
        kernels.reset_launch_counts()
        for f in frames:
            system.track(*f)
    st = system.tracker.stats
    assert st.failures == 0
    assert kernels.LAUNCHES["gicp_refine_fused"] == st.estimates
    assert kernels.LAUNCHES["detect_keypoints_fused"] == len(frames)
    _, poses = system.camera_trajectory()
    assert np.isfinite(poses).all() and len(poses) == len(frames)


def test_construction_refuses_the_limits_that_stay(dev, kernels, monkeypatch):
    """No detection limit is left on the card: a cell of 40, 76,800 cells
    (cells of 2 at 640x480) and 12 x1.2 levels build a Tracker, a SlamSystem
    and a PipelinedOdometry for the card, and each tracks a few tour frames
    through the kernels alone. What the JAX package refuses, a reprojection
    error model without a camera, is still refused."""
    from rgbdslam_tpu_torch.config import ExtractorConfig, RansacConfig, SlamConfig
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC
    from rgbdslam_tpu_torch.slam.pipeline import PipelinedOdometry
    from rgbdslam_tpu_torch.slam.system import SlamSystem
    from rgbdslam_tpu_torch.slam.tracking import Tracker

    _, frames = _tour_frames(dev, 6)
    for ecfg, detector in ((ExtractorConfig(cell_size=40), "svo_fast"),
                           (ExtractorConfig(cell_size=40), "orb"),
                           (ExtractorConfig(cell_size=2), "svo_fast"),
                           (ExtractorConfig(scale_factor=1.2, num_levels=12), "orb")):
        cfg = SlamConfig(extractor=ecfg, detector=detector)
        wrapper = ("detect_keypoints_scaled" if ecfg.scale_factor != 2.0 or detector == "orb"
                   else "detect_keypoints_fused")
        for cls in (Tracker, SlamSystem):
            system = cls(SYNTHETIC, cfg, device=dev)
            with forbid(monkeypatch):
                kernels.reset_launch_counts()
                for f in frames:
                    system.track(*f)
            assert kernels.LAUNCHES[wrapper] >= len(frames), (cls, ecfg, kernels.LAUNCHES)
            _, poses = system.camera_trajectory()
            assert np.isfinite(poses).all() and len(poses) == len(frames)
        odo = PipelinedOdometry(SYNTHETIC, cfg, batch=3, seed=0, device=dev)
        with forbid(monkeypatch):
            _, poses, _ = odo.run(frames)
        assert np.isfinite(poses).all() and len(poses) == len(frames)
    with pytest.raises(ValueError, match="camera"):
        SlamSystem(SYNTHETIC, SlamConfig(ransac=RansacConfig(error_model="both")), device=dev)
