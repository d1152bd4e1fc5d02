"""CUDA kernels of rgbdslam_tpu_torch against their plain PyTorch versions,
on the card. Every test here is marked `gpu` and skips without a card:

  python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances are those of chip_smoke.py: integer outputs exact (the kernels
are built with -fmad=false and round like the plain versions); sums that
are reduced in another order within the JAX kernel tests' tolerances.
"""

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


@pytest.mark.parametrize("shape", [(480, 640), (240, 320), (61, 83), (7, 9)])
def test_detect_kernel_matches_plain(dev, kernels, shape):
    g = torch.Generator(device=dev).manual_seed(shape[0])
    img = torch.randint(0, 256, shape, generator=g, device=dev).to(torch.float32)
    km, kr = kernels.detect_score_map(img, 20.0)
    pm, pr = kernels.detect_score_map_ref(img, 20.0)
    torch.testing.assert_close(kr, pr, rtol=1e-5, atol=1e-3)
    assert torch.equal(torch.isfinite(km), torch.isfinite(pm))
    keep = torch.isfinite(pm)
    torch.testing.assert_close(km[keep], pm[keep], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n,m", [(1024, 1024), (1000, 1500), (5, 3)])
def test_hamming_kernel_matches_plain(dev, kernels, n, m):
    g = torch.Generator(device=dev).manual_seed(n + m)
    d1 = torch.randint(-2**31, 2**31 - 1, (n, 8), generator=g, device=dev, dtype=torch.int32)
    d2 = torch.randint(-2**31, 2**31 - 1, (m, 8), generator=g, device=dev, dtype=torch.int32)
    d2[: min(n, m) // 2] = d1[: min(n, m) // 2] ^ (d2[: min(n, m) // 2] & 0x01010101)
    v1 = torch.rand(n, generator=g, device=dev) > 0.1
    v2 = torch.rand(m, generator=g, device=dev) > 0.1
    for a, b in zip(kernels.hamming_match_2nn(d1, d2, v1, v2),
                    kernels.hamming_match_2nn_ref(d1, d2, v1, v2)):
        assert torch.equal(a.long(), b.long())


def test_mahal_kernel_matches_plain(dev, kernels):
    from rgbdslam_tpu_torch.config import RansacConfig
    from rgbdslam_tpu_torch.geometry import se3
    from rgbdslam_tpu_torch.solvers.ransac_se3 import _sigma_diag

    g = torch.Generator(device=dev).manual_seed(0)
    T_h = se3.exp(0.1 * torch.randn(256, 6, generator=g, device=dev)).contiguous()
    p1 = torch.rand(1024, 3, generator=g, device=dev) * 2 - 1
    p1[:, 2] += 2.5
    p2 = p1 + 0.01 * torch.randn(1024, 3, generator=g, device=dev)
    T_h[0] = torch.eye(4, device=dev)
    valid = torch.rand(1024, generator=g, device=dev) > 0.2
    cfg = RansacConfig()
    s1, s2 = _sigma_diag(p1[:, 2], cfg), _sigma_diag(p2[:, 2], cfg)
    kc, ke = kernels.mahal_hypothesis_scores(T_h, p1, p2, s1, s2, valid, 9.0)
    pc, pe = kernels.mahal_hypothesis_scores_ref(T_h, p1, p2, s1, s2, valid, 9.0)
    assert torch.equal(kc, pc) and int(kc[0]) > 500
    torch.testing.assert_close(ke, pe, rtol=1e-5, atol=1e-4)
    kc, ke = kernels.mahal_hypothesis_scores(T_h, p1, p2, s1, s2, torch.zeros_like(valid), 9.0)
    assert int(kc.sum()) == 0 and float(ke.sum()) == 0.0


def test_gicp_kernel_matches_plain(dev, kernels):
    from rgbdslam_tpu_torch.geometry import se3

    g = torch.Generator(device=dev).manual_seed(1)
    N = 1024
    p1 = torch.rand(N, 3, generator=g, device=dev) * 2 - 1
    p1[:, 2] += 2.5
    T = se3.exp(0.03 * torch.randn(6, generator=g, device=dev))
    p2 = p1 @ T[:3, :3].T + T[:3, 3] + 0.004 * torch.randn(N, 3, generator=g, device=dev)
    A = 0.02 * torch.randn(N, 3, 3, generator=g, device=dev)
    C1 = (A @ A.transpose(1, 2) + 1e-4 * torch.eye(3, device=dev)).contiguous()
    C2 = C1.flip(0).contiguous()
    valid = torch.rand(N, generator=g, device=dev) > 0.2
    T0 = (se3.exp(0.02 * torch.randn(6, generator=g, device=dev)) @ T).contiguous()
    kT, kc, kn = kernels.gicp_refine_kernel(T0, p1, p2, C1, C2, valid, 10, 0.07)
    pT, pc, pn = kernels.gicp_refine_ref(T0, p1, p2, C1, C2, valid, 10, 0.07)
    torch.testing.assert_close(kT, pT, rtol=1e-4, atol=1e-5)
    assert abs(float(kn) - float(pn)) <= 1.0


def test_gicp_kernel_on_rendered_frame_pairs(dev, kernels):
    """Main-path inputs of the 640x480 sweep. Their depth-patch covariances
    come out slightly indefinite (one-pass moments cancel in f32), on which
    the Pallas kernel's Cholesky returned NaN; the kernel must stay finite
    and agree with the plain loop."""
    from rgbdslam_tpu_torch.config import SlamConfig
    from rgbdslam_tpu_torch.frontend.matcher import gather_matched_points, match_frames
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.slam.pipeline import PipelinedOdometry
    from rgbdslam_tpu_torch.solvers.ransac_se3 import ransac_se3

    cfg = SlamConfig()
    ds = SyntheticDataset(n_frames=48, cam=SYNTHETIC, trajectory="sweep", device=dev)
    odo = PipelinedOdometry(SYNTHETIC, cfg, device=dev)
    feats = [odo.features(*ds.grab(i)[1:]) for i in range(6)]
    for f0, f1 in zip(feats[:-1], feats[1:]):
        m = match_frames(f0, f1)
        p1, p2, w, valid = gather_matched_points(f0, f1, m)
        r = ransac_se3(p1, p2, w, valid, odo.generator, cfg.ransac)
        C2 = f1.surf_cov[m.idx2.long()].contiguous()
        inl, T0 = r.inliers.contiguous(), r.T21.contiguous()
        kT, _, kn = kernels.gicp_refine_kernel(T0, p1, p2, f0.surf_cov, C2, inl, 10, 0.07)
        pT, _, pn = kernels.gicp_refine_ref(T0, p1, p2, f0.surf_cov, C2, inl, 10, 0.07)
        assert torch.isfinite(kT).all()
        torch.testing.assert_close(kT, pT, rtol=1e-4, atol=1e-5)
        assert abs(float(kn) - float(pn)) <= 1.0


def test_renderer_on_card_equals_cpu(dev):
    """The renderer uses only elementwise f32 ops and one f64 rounding, so
    the card renders the CPU's bits (a BLAS matmul would not)."""
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC
    from rgbdslam_tpu_torch.io.synthetic import render_frame, sweep_trajectory

    for Twc in sweep_trajectory(48)[::7]:
        g_card, z_card = render_frame(SYNTHETIC, Twc, device=dev)
        g_cpu, z_cpu = render_frame(SYNTHETIC, Twc, device="cpu")
        assert torch.equal(z_card.cpu(), z_cpu)
        assert torch.equal(g_card.cpu(), g_cpu)


def test_pipeline_on_card_uses_only_kernels(dev, kernels):
    from rgbdslam_tpu_torch.config import ExtractorConfig, SlamConfig
    from rgbdslam_tpu_torch.eval.ate import ate_rmse
    from rgbdslam_tpu_torch.geometry.camera import Camera
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.slam.pipeline import PipelinedOdometry

    cam = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
    cfg = SlamConfig(extractor=ExtractorConfig(num_levels=3, cell_size=8, fast_threshold=15.0))
    ds = SyntheticDataset(n_frames=24, cam=cam, trajectory="sweep", device=dev)
    kernels.reset_launch_counts()
    ts, poses, st = PipelinedOdometry(cam, cfg, batch=8, device=dev).run(
        ds.grab(i) for i in range(len(ds)))
    assert kernels.LAUNCHES == {"detect_score_map": 3 * 24, "hamming_match_2nn": 23,
                                "mahal_hypothesis_scores": 23, "gicp_refine_kernel": 23}
    assert ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)[0] < 0.05
    assert st["failures"] == 0 and np.isfinite(poses).all()
