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


def _k4_loop(kernels, args, iters, md):
    """(T, cost, count) of the Gauss-Newton loop: the fused kernel's second
    result."""
    return kernels.gicp_refine_fused(*args, iters, md, 20)[1]


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
    kT, kc, kn = _k4_loop(kernels, (T0, p1, p2, C1, C2, valid), 10, 0.07)
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
        kT, _, kn = _k4_loop(kernels, (T0, p1, p2, f0.surf_cov, C2, inl), 10, 0.07)
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
    assert kernels.LAUNCHES == {"detect_score_map": 0, "detect_keypoints_fused": 24,
                                "hamming_match_2nn": 23,
                                "match_gates": 23, "mahal_hypothesis_scores": 0,
                                "ransac_se3_fused": 23, "gicp_refine_fused": 23,
                                "gicp_gn_normal_equations": 0}
    assert ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)[0] < 0.05
    assert st["failures"] == 0 and np.isfinite(poses).all()


def _gicp_problem(dev, seed, N=1024):
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
    T0 = (se3.exp(0.02 * torch.randn(6, generator=g, device=dev)) @ T).contiguous()
    return T0, p1, p2, C1, C2, valid


@pytest.mark.parametrize("n", [1024, 1000, 8])
def test_gicp_gn_kernel_matches_plain(dev, kernels, n):
    """K5 against its plain version: H and b relative to max|H| at 1e-5
    (the float sums run in another order), the gated count exact."""
    args = _gicp_problem(dev, 7, n)
    kH, kb, kc, kn = kernels.gicp_gn_normal_equations(*args, 0.07)
    pH, pb, pc, pn = kernels.gicp_gn_normal_equations_ref(*args, 0.07)
    scale = float(pH.abs().max())
    assert float((kH - pH).abs().max()) <= 1e-5 * scale
    assert float((kb - pb).abs().max()) <= 1e-5 * scale
    torch.testing.assert_close(kc, pc, rtol=1e-4, atol=1e-6)
    assert float(kn) == float(pn) and float(kn) > 0.5 * n
    assert torch.equal(kH, kH.T)


def test_gicp_gn_kernel_consistent_with_loop_kernel(dev, kernels):
    """One round of K4 is K5's build, the damped solve and the exp-compose:
    exp(solve(H + 1e-6 I, -b)) @ T0 in float64 equals K4 at iters=1 (1e-5);
    the two share the per-point function and the block reduction, so cost
    and count are the same bits."""
    from rgbdslam_tpu_torch.geometry import se3

    args = _gicp_problem(dev, 11)
    H, b, cost, cnt = kernels.gicp_gn_normal_equations(*args, 0.07)
    T1, c1, n1 = kernels.gicp_refine_fused(*args, 1, 0.07, 20)[1]
    xi = torch.linalg.solve(H.double() + 1e-6 * torch.eye(6, device=dev, dtype=torch.float64),
                            -b.double())
    T_ref = (se3.exp(xi) @ args[0].double()).float()
    torch.testing.assert_close(T1, T_ref, rtol=0, atol=1e-5)
    assert float(c1) == float(cost) and float(n1) == float(cnt)


@pytest.mark.parametrize("batched2", [False, True])
def test_hamming_kernel_batched_matches_plain(dev, kernels, batched2):
    """K2 with 13 query sets in one launch: every output equal to the plain
    version's, and row b of the batch equal to the unbatched call on entry b."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, n, m = 13, 1024, 1024
    d1 = torch.randint(-2**31, 2**31 - 1, (B, n, 8), generator=g, device=dev, dtype=torch.int32)
    d2 = torch.randint(-2**31, 2**31 - 1, (B, m, 8) if batched2 else (m, 8), generator=g,
                       device=dev, dtype=torch.int32)
    d1[:, : n // 2] = d2[..., : n // 2, :] ^ (d1[:, : n // 2] & 0x01010101)
    v1 = torch.rand(B, n, generator=g, device=dev) > 0.1
    v2 = torch.rand((B, m) if batched2 else (m,), generator=g, device=dev) > 0.1
    ko = kernels.hamming_match_2nn(d1, d2, v1, v2)
    po = kernels.hamming_match_2nn_ref(d1, d2, v1, v2)
    for a, b in zip(ko, po):
        assert a.shape == b.shape and torch.equal(a.long(), b.long())
    one = kernels.hamming_match_2nn(d1[3].contiguous(), d2[3].contiguous() if batched2 else d2,
                                    v1[3].contiguous(), v2[3].contiguous() if batched2 else v2)
    for a, b in zip(ko, one):
        assert torch.equal(a[3], b)


def test_mahal_kernel_batched_matches_plain(dev, kernels):
    """K3 with 13 problems in one launch: counts exact, error sums within
    rtol 1e-5 (sum order), and entry b bit-equal to the unbatched call."""
    from rgbdslam_tpu_torch.config import RansacConfig
    from rgbdslam_tpu_torch.geometry import se3
    from rgbdslam_tpu_torch.solvers.ransac_se3 import _sigma_diag

    g = torch.Generator(device=dev).manual_seed(2)
    B = 13
    T_h = se3.exp(0.1 * torch.randn(B, 256, 6, generator=g, device=dev)).contiguous()
    p1 = torch.rand(B, 1024, 3, generator=g, device=dev) * 2 - 1
    p1[..., 2] += 2.5
    p2 = p1 + 0.01 * torch.randn(B, 1024, 3, generator=g, device=dev)
    T_h[:, 0] = torch.eye(4, device=dev)
    valid = torch.rand(B, 1024, generator=g, device=dev) > 0.2
    cfg = RansacConfig()
    s1, s2 = _sigma_diag(p1[..., 2], cfg), _sigma_diag(p2[..., 2], cfg)
    kc, ke = kernels.mahal_hypothesis_scores(T_h, p1, p2, s1, s2, valid, 9.0)
    pc, pe = kernels.mahal_hypothesis_scores_ref(T_h, p1, p2, s1, s2, valid, 9.0)
    assert kc.shape == (B, 256) and torch.equal(kc, pc) and int(kc[:, 0].min()) > 500
    torch.testing.assert_close(ke, pe, rtol=1e-5, atol=1e-4)
    oc, oe = kernels.mahal_hypothesis_scores(
        T_h[5].contiguous(), p1[5].contiguous(), p2[5].contiguous(), s1[5].contiguous(),
        s2[5].contiguous(), valid[5].contiguous(), 9.0)
    assert torch.equal(oc, kc[5]) and torch.equal(oe, ke[5])


def test_batched_ransac_on_card_matches_per_entry(dev, kernels):
    """ransac_se3 over a batch with injected draws equals the unbatched
    call on each entry (same kernels, batch of one)."""
    from rgbdslam_tpu_torch.config import RansacConfig
    from rgbdslam_tpu_torch.frontend.matcher import correspondence_weights
    from rgbdslam_tpu_torch.geometry import se3
    from rgbdslam_tpu_torch.solvers.ransac_se3 import ransac_se3

    g = torch.Generator(device=dev).manual_seed(4)
    B, N = 5, 512
    cfg = RansacConfig()
    p1 = torch.rand(B, N, 3, generator=g, device=dev) * 2 - 1
    p1[..., 2] += 2.5
    T = se3.exp(0.05 * torch.randn(B, 6, generator=g, device=dev))
    p2 = p1 @ T[:, :3, :3].transpose(1, 2) + T[:, None, :3, 3]
    p2 = p2 + 0.003 * torch.randn(B, N, 3, generator=g, device=dev)
    valid = torch.rand(B, N, generator=g, device=dev) > 0.3
    w = correspondence_weights(p1, p2, valid)
    draws = torch.randint(0, 100, (B, cfg.num_hypotheses, cfg.sample_size), generator=g,
                          device=dev)
    kernels.reset_launch_counts()
    rb = ransac_se3(p1, p2, w, valid, cfg=cfg, draws=draws)
    assert kernels.LAUNCHES["ransac_se3_fused"] == 1
    assert kernels.LAUNCHES["mahal_hypothesis_scores"] == 0
    for i in range(B):
        r1 = ransac_se3(p1[i], p2[i], w[i], valid[i], cfg=cfg, draws=draws[i])
        assert int(r1.num_inliers) == int(rb.num_inliers[i])
        assert torch.equal(r1.inliers, rb.inliers[i])
        torch.testing.assert_close(r1.T21, rb.T21[i], rtol=1e-5, atol=1e-6)
    assert bool(rb.success.all())


def test_slam_system_on_card_uses_only_kernels(dev, kernels):
    """Serial full SLAM at 320x240 on the card: the backend's candidate
    verification rides one batched call of the gated matcher and of the
    fused RANSAC per keyframe, and the launch counts follow the run's
    bookkeeping."""
    from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, SlamConfig
    from rgbdslam_tpu_torch.eval.ate import ate_rmse
    from rgbdslam_tpu_torch.geometry.camera import Camera
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
    from rgbdslam_tpu_torch.slam.system import SlamSystem

    cam = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
    cfg = SlamConfig(extractor=ExtractorConfig(num_levels=3, cell_size=8, fast_threshold=15.0),
                     loop=LoopConfig(id_interval=12, min_kfs_since_loop=10))
    ds = SyntheticDataset(n_frames=60, cam=cam, trajectory="orbit", loops=1.15, device=dev)
    system = SlamSystem(cam, cfg, seed=0, device=dev)
    system.load_vocabulary(shipped_vocabulary("svo_fast"))
    kernels.reset_launch_counts()
    for i in range(len(ds)):
        system.track(*ds.grab(i))
    system.finish()
    E, KF, R = system.tracker.stats.estimates, system.store.count, system.reloc_verifications
    assert kernels.LAUNCHES == {"detect_score_map": 0, "detect_keypoints_fused": 60,
                                "hamming_match_2nn": E + 2 * KF + R,
                                "match_gates": E + 2 * KF + R, "mahal_hypothesis_scores": 0,
                                "ransac_se3_fused": E + KF + R, "gicp_refine_fused": E,
                                "gicp_gn_normal_equations": 0}
    assert kernels.BATCHED_LAUNCHES == {"hamming_match_2nn": KF + R, "match_gates": KF + R,
                                        "mahal_hypothesis_scores": 0,
                                        "ransac_se3_fused": KF + R}
    ts, poses = system.camera_trajectory()
    assert ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)[0] < 0.06
    assert KF >= 10 and system.graph.n_vertices == KF and system.graph.n_edges > KF - 1
    assert system.tracker.stats.failures <= 3 and np.isfinite(poses).all()


# ---------------------------------------------------------------------------
# the gated matcher and the fused RANSAC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lead1,lead2,n,m", [
    ((), (), 1024, 1024), ((), (), 1000, 1500), ((), (), 5, 3),
    ((13,), (), 1024, 1024), ((4,), (4,), 300, 260)])
def test_match_gated_matches_plain(dev, kernels, lead1, lead2, n, m):
    """The gated matcher (2-NN kernel + gate kernel, two launches) against
    the plain 2-NN and tensor gates: idx2, dist and valid all exact, and a
    valid match always lands on a valid train row."""
    g = torch.Generator(device=dev).manual_seed(n + m + len(lead1))
    d1 = torch.randint(-2**31, 2**31 - 1, lead1 + (n, 8), generator=g, device=dev,
                       dtype=torch.int32)
    d2 = torch.randint(-2**31, 2**31 - 1, lead2 + (m, 8), generator=g, device=dev,
                       dtype=torch.int32)
    k = min(n, m) // 2
    d1[..., :k, :] = d2[..., :k, :] ^ (d1[..., :k, :] & 0x01010101)
    v1 = torch.rand(lead1 + (n,), generator=g, device=dev) > 0.1
    v2 = torch.rand(lead2 + (m,), generator=g, device=dev) > 0.1
    kernels.reset_launch_counts()
    ko = kernels.match_gated(d1, d2, v1, v2, 0.9)
    assert kernels.LAUNCHES["hamming_match_2nn"] == 1 and kernels.LAUNCHES["match_gates"] == 1
    po = kernels.match_gated_ref(d1, d2, v1, v2, 0.9)
    for a, b in zip(ko, po):
        assert a.shape == b.shape and torch.equal(a.long(), b.long())
    assert ko[2].dtype == torch.bool and (k < 2 or int(ko[2].sum()) > 0)
    v2_at = torch.gather(v2.expand(ko[0].shape[:-1] + (m,)), -1, ko[0].long())
    assert bool((v2_at | ~ko[2]).all())


def _ransac_problem(dev, seed, lead=(), N=1024, outliers=0.3, p_valid=0.7):
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
    return p1.contiguous(), p2.contiguous(), w, valid, T, g


def _check_fused_against_plain(kernels, p1, p2, w, valid, cfg, u=None, draws=None):
    """The held-apart comparisons of the fused RANSAC: kernel A's poses
    against the plain fit (atol 5e-5: 30 power iterations summed in another
    order, the bound the CPU tests hold between torch and XLA), kernel A's
    counts exact and sums rtol 1e-5 against the plain scorer on kernel A's
    own poses, kernel B against the plain selection and refits on kernel
    A's outputs, and the whole against the whole plain version."""
    from rgbdslam_tpu_torch.solvers import ransac_se3 as rs

    res, (T_h, cnt_h, err_h) = rs.ransac_se3_cuda(p1, p2, w, valid, cfg, u=u, draws=draws)
    assert res.T21.shape == p1.shape[:-2] + (4, 4) and res.inliers.shape == valid.shape
    pT_h, pcnt_h, perr_h = rs.hypotheses_ref(p1, p2, w, valid, cfg, u=u, draws=draws)
    # a sample of nearly coincident points leaves its fit ill-determined and
    # float32 rounding moves it by more than 5e-5 in any implementation: the
    # bound is then 10 x the plain fit's own distance from its float64
    # evaluation; four draws of one slot give a NaN pose in all (S = 0)
    d64 = draws
    if d64 is None:                     # the draws the f32 product u * n_valid gives
        nv = torch.clamp_min(valid.sum(-1), 1)[..., None, None]
        d64 = torch.minimum(torch.floor(u * nv).to(torch.int64), nv - 1)
    T64 = rs.hypothesis_fits_ref(p1.double(), p2.double(), w.double(), valid,
                                 cfg.num_hypotheses, draws=d64)
    own = (pT_h.double() - T64).abs().amax((-1, -2), keepdim=True).nan_to_num(0.0)
    tol = torch.clamp_min(10.0 * own, 5e-5)
    diff = (T_h.double() - pT_h.double()).abs()
    assert bool(((diff <= tol) | (torch.isnan(T_h) & torch.isnan(pT_h))).all())
    # few hypotheses may take the wider bound, and each of them scores within
    # 2 inliers of the plain fit's pose (the whole RANSAC's own count bound)
    loose = (10.0 * own > 5e-5)[..., 0, 0]
    assert int(loose.sum()) <= 0.03 * loose.numel()
    assert int(((cnt_h.long() - pcnt_h.long()).abs() * loose).max()) <= 2
    s1, s2 = rs._sigma_diag(p1[..., 2], cfg), rs._sigma_diag(p2[..., 2], cfg)
    th = cfg.max_mahalanobis ** 2
    acnt, aerr = kernels.mahal_hypothesis_scores_ref(T_h, p1, p2, s1, s2, valid, th)
    assert torch.equal(cnt_h, acnt)
    torch.testing.assert_close(err_h, aerr, rtol=1e-5, atol=1e-4)
    # kernel B on kernel A's outputs: the refits sum in another order, so a
    # correspondence on the threshold may change sides (count within 2) and
    # the pose moves in its last digits
    pb = rs.select_refine_ref(T_h, cnt_h, err_h, p1, p2, w, valid, cfg)
    _same_result(res, pb)
    # the whole against the whole: the same tolerances (hypothesis poses
    # differ in their last bits, so may the winner among equal counts)
    pw = rs.select_refine_ref(pT_h, pcnt_h, perr_h, p1, p2, w, valid, cfg)
    _same_result(res, pw)
    return res


def _same_result(a, b):
    assert torch.equal(a.success, b.success)
    assert int((a.num_inliers.long() - b.num_inliers.long()).abs().max()) <= 2
    torch.testing.assert_close(a.T21, b.T21, rtol=1e-4, atol=5e-5)
    assert int((a.inliers != b.inliers).sum(-1).max()) <= 2
    ok = a.num_inliers >= 3
    torch.testing.assert_close(a.rmse[ok], b.rmse[ok], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("lead,N,outliers", [((), 1024, 0.3), ((13,), 1024, 0.5),
                                             ((), 1000, 0.0), ((3,), 333, 0.3),
                                             ((), 4096, 0.3)])
def test_ransac_fused_matches_plain_with_draws(dev, kernels, lead, N, outliers):
    from rgbdslam_tpu_torch.config import RansacConfig

    cfg = RansacConfig()
    p1, p2, w, valid, T, g = _ransac_problem(dev, N + len(lead), lead, N, outliers)
    draws = torch.randint(0, N // 2, lead + (cfg.num_hypotheses, 4), generator=g, device=dev)
    res = _check_fused_against_plain(kernels, p1, p2, w, valid, cfg, draws=draws)
    assert bool(res.success.all())
    # the truth, roughly: the refits are kept only while count and rmse both
    # improve, so the winner stays near its 4-point fit, and the plain
    # version (held to 5e-5 above) lies as far from the truth
    torch.testing.assert_close(res.T21, T, rtol=0, atol=2e-2)


@pytest.mark.parametrize("lead", [(), (13,)])
def test_ransac_fused_matches_plain_with_uniforms(dev, kernels, lead):
    """The kernel turns the uniforms into draws as the plain version does
    (floor(u * n_valid), clamped), so the hypotheses are the same ones."""
    from rgbdslam_tpu_torch.config import RansacConfig

    cfg = RansacConfig()
    p1, p2, w, valid, T, g = _ransac_problem(dev, 77, lead)
    u = torch.rand(lead + (cfg.num_hypotheses, 4), generator=g, device=dev)
    u[..., 1, 0] = 0.99999994          # the largest f32 below 1: clamps to n_valid - 1
    _check_fused_against_plain(kernels, p1, p2, w, valid, cfg, u=u)


def test_ransac_fused_all_invalid_and_few_inliers(dev, kernels):
    """Batch entries with no valid slot (padded candidates): every draw
    hits slot 0, every fit is the identity, success is false. An entry with
    two valid slots has fewer than 3 inliers and keeps rmse 1e9."""
    from rgbdslam_tpu_torch.config import RansacConfig
    from rgbdslam_tpu_torch.solvers.ransac_se3 import ransac_se3, ransac_se3_ref

    cfg = RansacConfig()
    p1, p2, w, valid, _, g = _ransac_problem(dev, 5, (4,))
    valid[1] = False
    valid[3] = False
    w[1] = 0.0
    w[3] = 0.0
    keep = torch.nonzero(valid[2])[:2, 0]
    valid[2] = False
    valid[2, keep] = True
    w[2] = w[2] * valid[2]
    gen = torch.Generator(device=dev).manual_seed(0)
    res = ransac_se3(p1, p2, w, valid, gen, cfg)
    assert res.success.tolist()[1::2] == [False, False] and bool(res.success[0])
    eye = torch.eye(4, device=dev)
    assert torch.equal(res.T21[1], eye) and torch.equal(res.T21[3], eye)
    assert int(res.inliers[1].sum()) == 0 and int(res.num_inliers[1]) == 0
    assert float(res.rmse[1]) == 1e9
    assert not bool(res.success[2]) and int(res.inliers[2].sum()) == 0
    assert int(res.num_inliers[2]) <= 2 and float(res.rmse[2]) == 1e9
    ref = ransac_se3_ref(p1, p2, w, valid, torch.Generator(device=dev).manual_seed(0), cfg)
    _same_result(res, ref)
    one = ransac_se3(p1[1], p2[1], w[1], valid[1], gen, cfg)
    assert not bool(one.success) and torch.equal(one.T21, eye)


def test_ransac_on_card_never_reaches_plain_version(dev, kernels, monkeypatch):
    from rgbdslam_tpu_torch.config import RansacConfig
    from rgbdslam_tpu_torch.solvers import ransac_se3 as rs

    def forbid(*a, **k):
        raise AssertionError("plain version ran for CUDA tensors")

    for name in ("ransac_se3_ref", "hypotheses_ref", "hypothesis_fits_ref",
                 "select_refine_ref"):
        monkeypatch.setattr(rs, name, forbid)
    monkeypatch.setattr(kernels, "mahal_hypothesis_scores_ref", forbid)
    p1, p2, w, valid, T, g = _ransac_problem(dev, 9)
    kernels.reset_launch_counts()
    res = rs.ransac_se3(p1, p2, w, valid, g, RansacConfig())
    assert kernels.LAUNCHES["ransac_se3_fused"] == 1 and bool(res.success)
    torch.testing.assert_close(res.T21, T, rtol=0, atol=1e-2)
    with pytest.raises(NotImplementedError):
        rs.ransac_se3(p1, p2, w, valid, g, RansacConfig(sample_size=3))
    with pytest.raises(ValueError):
        rs.ransac_se3(p1.cpu(), p2, w, valid, g, RansacConfig())


def test_ransac_fused_reproduces_its_run(dev, kernels):
    """Fixed reduction trees, no float atomics: the same inputs give the
    same bits."""
    from rgbdslam_tpu_torch.config import RansacConfig
    from rgbdslam_tpu_torch.solvers.ransac_se3 import ransac_se3

    p1, p2, w, valid, _, g = _ransac_problem(dev, 21, (13,))
    runs = [ransac_se3(p1, p2, w, valid, torch.Generator(device=dev).manual_seed(3),
                       RansacConfig()) for _ in range(2)]
    for f in ("T21", "inliers", "num_inliers", "rmse", "success"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f))


# ---------------------------------------------------------------------------
# the whole detection (kernels A and B of detect.cu) and the whole gicp_refine
# ---------------------------------------------------------------------------

_DETECT_CASES = [
    # (h, w), levels, cell_size, fast threshold, min_border
    ((480, 640), 4, 16, 20.0, 16),
    ((240, 320), 3, 8, 15.0, 16),
    ((251, 333), 3, 8, 15.0, 9),      # odd: levels are not whole tiles or cells
]


def _same_keypoints(a, b):
    for f in ("uv", "level", "score", "valid"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), f


@pytest.mark.parametrize("kind", ["integer", "coarse", "rendered"])
@pytest.mark.parametrize("shape,levels,cell,thr,border", _DETECT_CASES)
def test_detect_fused_matches_plain(dev, kernels, kind, shape, levels, cell, thr, border):
    """Kernel A against the first half of the plain detection, kernel B
    against the second half on kernel A's outputs, the whole against the
    whole: all exact (same operation order, -fmad=false). `coarse` images
    take few grey values, so equal scores inside a cell and across cells
    are common and the first-index and lower-cell-first rules decide."""
    from rgbdslam_tpu_torch.geometry.camera import Camera
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.ops import fast, image

    h, w = shape
    g = torch.Generator(device=dev).manual_seed(h + levels)
    if kind == "rendered":
        cam = Camera(0.9 * w, 0.9 * w, (w - 1) / 2, (h - 1) / 2, width=w, height=h)
        img = SyntheticDataset(n_frames=24, cam=cam, trajectory="sweep", device=dev).grab(3)[1]
    else:
        step = 1 if kind == "integer" else 64
        img = (torch.randint(0, 256 // step, shape, generator=g, device=dev) * step
               ).to(torch.float32)
    pyr = image.build_pyramid(img, levels)
    kw = dict(num_features=1024, cell_size=cell, fast_threshold=thr, min_response=20.0,
              min_border=border)
    kernels.reset_launch_counts()
    kp, (cmax, carg) = kernels.detect_keypoints_fused(pyr, **kw)
    assert kernels.LAUNCHES["detect_keypoints_fused"] == 1
    assert kernels.LAUNCHES["detect_score_map"] == 0
    pmax, parg = fast.detect_cells_ref(pyr, cell, thr, border)
    assert torch.equal(cmax, pmax) and torch.equal(carg, parg)
    grid_cols = w // cell
    _same_keypoints(kp, fast.detect_select_ref(cmax, carg, grid_cols, 1024, cell, 20.0))
    _same_keypoints(kp, fast.detect_keypoints_ref(pyr, **kw))
    _same_keypoints(kp, fast.detect_keypoints(pyr, **kw))
    assert int(kp.valid.sum()) > 20
    if kind == "coarse":
        best = cmax.max(0).values
        assert int((best[:, None] == best[None, :]).sum()) > best.numel()   # ties exist


def test_detect_fused_pads_beyond_cells(dev, kernels):
    """A budget above the number of cells: the slots beyond the cells are
    padded (invalid, zero), equal scores rank by cell index, in kernel B as
    in the plain selection on kernel A's outputs and in the whole."""
    from rgbdslam_tpu_torch.ops import fast, image

    g = torch.Generator(device=dev).manual_seed(3)
    img = (torch.randint(0, 4, (96, 128), generator=g, device=dev) * 64).to(torch.float32)
    pyr = image.build_pyramid(img, 3)
    cell, grid_cols, n_cells = 8, 16, 12 * 16
    for n_feat in (64, 500):
        kp, (cmax, carg) = kernels.detect_keypoints_fused(pyr, n_feat, cell, 15.0, 20.0, 8)
        _same_keypoints(kp, fast.detect_select_ref(cmax, carg, grid_cols, n_feat, cell, 20.0))
        _same_keypoints(kp, fast.detect_keypoints_ref(pyr, n_feat, cell, 15.0, 20.0, 8))
        assert kp.valid.shape == (n_feat,) and int(kp.valid.sum()) > 20
    assert not bool(kp.valid[n_cells:].any()) and float(kp.uv[n_cells:].abs().sum()) == 0.0
    assert float(kp.score[n_cells:].abs().sum()) == 0.0 and int(kp.level[n_cells:].sum()) == 0


def test_detect_on_card_never_reaches_plain_version(dev, kernels, monkeypatch):
    from rgbdslam_tpu_torch.ops import fast, image

    def forbid(*a, **k):
        raise AssertionError("plain version ran for CUDA tensors")

    g = torch.Generator(device=dev).manual_seed(8)
    img = torch.randint(0, 256, (240, 320), generator=g, device=dev).to(torch.float32)
    pyr = image.build_pyramid(img, 3)
    kw = dict(num_features=512, cell_size=8, fast_threshold=15.0, min_response=20.0,
              min_border=16)
    ref = fast.detect_keypoints_ref(pyr, **kw)
    for name in ("detect_keypoints_ref", "detect_cells_ref", "detect_select_ref"):
        monkeypatch.setattr(fast, name, forbid)
    monkeypatch.setattr(kernels, "detect_score_map_ref", forbid)
    runs = [fast.detect_keypoints(pyr, **kw) for _ in range(2)]
    _same_keypoints(runs[0], runs[1])                   # the same bits again
    _same_keypoints(runs[0], ref)
    # an all-dark frame: no corner, every slot invalid and zero
    dark = fast.detect_keypoints(image.build_pyramid(torch.zeros_like(img), 3), **kw)
    assert not bool(dark.valid.any()) and float(dark.uv.abs().sum()) == 0.0
    assert float(dark.score.abs().sum()) == 0.0 and int(dark.level.sum()) == 0
    # shapes the kernels do not take raise
    with pytest.raises(ValueError, match="whole number"):
        fast.detect_keypoints(pyr, **{**kw, "cell_size": 10})
    with pytest.raises(ValueError, match="whole number"):
        fast.detect_keypoints(pyr, **{**kw, "cell_size": 32})
    with pytest.raises(ValueError):
        fast.detect_keypoints([pyr[0], pyr[1].cpu()], **kw)
    # more levels than cells have pixels: the plain version's break
    deep = image.build_pyramid(img, 5)
    _same_keypoints(fast.detect_keypoints(deep, **kw),
                    kernels.detect_keypoints_fused(deep[:4], **kw)[0])


def _finish_plain(kernels, args, iters, md, min_matches):
    from rgbdslam_tpu_torch.config import IcpConfig
    from rgbdslam_tpu_torch.solvers.icp import _finish_gicp

    T0, p1, p2, C1, C2, valid = args
    T_fin, cost, cnt = kernels.gicp_refine_ref(*args, iters, md)
    cfg = IcpConfig(max_iterations=iters, max_correspondence_dist=md, min_matches=min_matches)
    return _finish_gicp(T_fin, T0, p1, p2, valid, cfg), T_fin


@pytest.mark.parametrize("n,min_matches", [(1024, 20), (3000, 20), (1000, 20), (8, 20),
                                           (64, 60)])
def test_gicp_refine_fused_matches_plain(dev, kernels, n, min_matches):
    """The whole gicp_refine in one launch against the plain loop and gate
    on SPD covariances: converged and n_valid exact, the pose within the
    loop's tolerance; too few valid pairs fall back to T_init exactly."""
    args = _gicp_problem(dev, 30 + n, n)
    kernels.reset_launch_counts()
    (kT, kconv, knv), (kfin, _, _) = kernels.gicp_refine_fused(*args, 10, 0.07, min_matches)
    assert kernels.LAUNCHES["gicp_refine_fused"] == 1
    (pT, pconv, pnv), pfin = _finish_plain(kernels, args, 10, 0.07, min_matches)
    assert kconv.dtype == torch.bool and knv.dtype == torch.int32 and kT.shape == (4, 4)
    assert bool(kconv) == bool(pconv) and int(knv) == int(pnv) == int(args[5].sum())
    assert bool(kconv) == (int(knv) >= min_matches)
    torch.testing.assert_close(kfin, pfin, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(kT, pT, rtol=1e-4, atol=1e-5)
    if not bool(kconv):
        assert torch.equal(kT, args[0])
    again = kernels.gicp_refine_fused(*args, 10, 0.07, min_matches)
    assert torch.equal(again[0][0], kT) and torch.equal(again[1][0], kfin)   # same bits


def test_gicp_refine_fused_gate_and_limits(dev, kernels, monkeypatch):
    """A non-finite final pose falls back to T_init; pairs that end farther
    apart than max_dist do not count; more points than shared memory holds
    raise; the public entry never reaches a plain version."""
    from rgbdslam_tpu_torch.config import IcpConfig
    from rgbdslam_tpu_torch.solvers import icp

    T0, p1, p2, C1, C2, valid = _gicp_problem(dev, 41)
    bad = p1.clone()
    bad[int(torch.nonzero(valid)[0])] = float("inf")
    (kT, kconv, knv), (kfin, _, _) = kernels.gicp_refine_fused(T0, bad, p2, C1, C2, valid,
                                                               10, 0.07, 20)
    (pT, pconv, pnv), pfin = _finish_plain(kernels, (T0, bad, p2, C1, C2, valid), 10, 0.07, 20)
    assert not bool(torch.isfinite(kfin).all()) and not bool(torch.isfinite(pfin).all())
    assert not bool(kconv) and not bool(pconv) and int(knv) == int(pnv)
    assert torch.equal(kT, T0) and torch.equal(pT, T0)
    # the partners moved away: the loop's gate empties, the final count fails
    far = p2 + 1.0
    (kT, kconv, knv), _ = kernels.gicp_refine_fused(T0, p1, far, C1, C2, valid, 10, 0.07, 20)
    (pT, pconv, pnv), _ = _finish_plain(kernels, (T0, p1, far, C1, C2, valid), 10, 0.07, 20)
    assert not bool(kconv) and not bool(pconv) and int(knv) == int(pnv) > 20
    assert torch.equal(kT, T0)
    with pytest.raises(ValueError, match="3000"):
        kernels.gicp_refine_fused(*_gicp_problem(dev, 42, 3001), 10, 0.07, 20)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gicp_refine_fused(T0.T, p1, p2, C1, C2, valid, 10, 0.07, 20)

    def forbid(*a, **k):
        raise AssertionError("plain version ran for CUDA tensors")

    monkeypatch.setattr(kernels, "gicp_refine_ref", forbid)
    monkeypatch.setattr(icp, "_finish_gicp", forbid)
    kernels.reset_launch_counts()
    T, conv, nv = icp.gicp_refine(p1, p2, valid, T0, IcpConfig(), C1=C1, C2=C2)
    assert kernels.LAUNCHES["gicp_refine_fused"] == 1
    assert bool(conv) and int(nv) == int(valid.sum()) and bool(torch.isfinite(T).all())
    with pytest.raises(ValueError):
        icp.gicp_refine(p1.cpu(), p2, valid, T0, IcpConfig(), C1=C1, C2=C2)


def test_gicp_refine_fused_on_rendered_frame_pairs(dev, kernels):
    """Main-path inputs (indefinite depth-patch covariances): the whole
    gicp_refine against the plain loop and gate, converged and n_valid
    exact."""
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
        args = (r.T21, p1, p2, f0.surf_cov, f1.surf_cov[m.idx2.long()], r.inliers)
        (kT, kconv, knv), _ = kernels.gicp_refine_fused(*args, 10, 0.07, 20)
        (pT, pconv, pnv), _ = _finish_plain(kernels, args, 10, 0.07, 20)
        assert bool(kconv) and bool(pconv) and int(knv) == int(pnv)
        torch.testing.assert_close(kT, pT, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the batched and ring modes: K1's device threshold, host synchronisations
# ---------------------------------------------------------------------------


def _sync_calls(fn):
    """(synchronising calls torch reports while fn() runs, fn's result)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message).lower() for w in caught), out


@pytest.mark.parametrize("kind", ["integer", "rendered"])
@pytest.mark.parametrize("shape,levels,cell,thr,border", _DETECT_CASES)
def test_detect_fused_tensor_threshold_matches_float(dev, kernels, kind, shape, levels, cell,
                                                     thr, border):
    """Kernel A reads the FAST threshold from device memory: a 0-dim f32
    tensor gives the keypoints of the same threshold passed as a float, bit
    for bit (also at a threshold the ADAPTIVE rule reaches, x0.7), and
    neither call waits for the device."""
    from rgbdslam_tpu_torch.geometry.camera import Camera
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.ops import fast, image

    h, w = shape
    g = torch.Generator(device=dev).manual_seed(h + 7)
    if kind == "rendered":
        cam = Camera(0.9 * w, 0.9 * w, (w - 1) / 2, (h - 1) / 2, width=w, height=h)
        img = SyntheticDataset(n_frames=24, cam=cam, trajectory="orbit", device=dev).grab(5)[1]
    else:
        img = torch.randint(0, 256, shape, generator=g, device=dev).to(torch.float32)
    pyr = image.build_pyramid(img, levels)
    for t in (thr, thr * 0.7):
        t_dev = torch.full((), t, dtype=torch.float32, device=dev)
        kw = dict(num_features=1024, cell_size=cell, min_response=20.0, min_border=border)
        kernels.detect_keypoints_fused(pyr, fast_threshold=t, **kw)     # first use of t
        n_float, (a, _) = _sync_calls(
            lambda: kernels.detect_keypoints_fused(pyr, fast_threshold=t, **kw))
        n_tensor, (b, _) = _sync_calls(
            lambda: kernels.detect_keypoints_fused(pyr, fast_threshold=t_dev, **kw))
        assert n_float == 0 and n_tensor == 0
        _same_keypoints(a, b)
        _same_keypoints(b, fast.detect_keypoints_ref(pyr, fast_threshold=t_dev, **kw))
        assert int(b.valid.sum()) > 20
    with pytest.raises(TypeError):
        kernels.detect_keypoints_fused(pyr, fast_threshold=t_dev.double(), **kw)
    with pytest.raises(ValueError):
        kernels.detect_keypoints_fused(pyr, fast_threshold=t_dev.cpu(), **kw)


def _orbit_system(dev, n=24):
    from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, SlamConfig
    from rgbdslam_tpu_torch.geometry.camera import Camera
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
    from rgbdslam_tpu_torch.slam.system import SlamSystem

    cam = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
    cfg = SlamConfig(extractor=ExtractorConfig(num_levels=3, cell_size=8, fast_threshold=15.0),
                     loop=LoopConfig(id_interval=12, min_kfs_since_loop=10))
    ds = SyntheticDataset(n_frames=48, cam=cam, trajectory="orbit", device=dev)
    system = SlamSystem(cam, cfg, seed=0, device=dev)
    system.load_vocabulary(shipped_vocabulary("svo_fast"))
    return ds, [ds.grab(i) for i in range(n)], system


def _counts(system):
    st = system.tracker.stats
    return np.array([st.estimates, system.store.count, system.loops_closed,
                     system.reloc_verifications])


def test_batch_on_card_within_sync_budget(dev, kernels):
    """Double-buffered batches of 8 on the card: no dispatch waits for the
    device; a completion reads once for its rows (keyframe 0's blob rides
    the first), once more for the blobs of the keyframes it dispatched, once
    per loop closure and twice per relocalization. Launches follow the
    formula with one estimate per frame after the first."""
    from rgbdslam_tpu_torch.eval.ate import ate_rmse

    ds, frames, system = _orbit_system(dev)
    kernels.reset_launch_counts()
    pending = None
    for i in range(0, len(frames), 8):
        c = frames[i:i + 8]
        n_disp, h = _sync_calls(lambda: system.track_batch_dispatch(*zip(*c)))
        assert n_disp == 0
        if pending is not None:
            before = _counts(system)
            n, _ = _sync_calls(lambda: system.track_batch_complete(pending))
            _, dK, dL, dR = _counts(system) - before
            assert n == 1 + int(dK > 0) + dL + 2 * dR, (n, dK, dL, dR)
        pending = h
    system.track_batch_complete(pending)
    system.finish()
    E, KF, R = system.tracker.stats.estimates, system.store.count, system.reloc_verifications
    assert E == len(frames) - 1
    assert kernels.LAUNCHES == {"detect_score_map": 0, "detect_keypoints_fused": len(frames),
                                "hamming_match_2nn": E + 2 * KF + R,
                                "match_gates": E + 2 * KF + R, "mahal_hypothesis_scores": 0,
                                "ransac_se3_fused": E + KF + R, "gicp_refine_fused": E,
                                "gicp_gn_normal_equations": 0}
    ts, poses = system.camera_trajectory()
    assert ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)[0] < 0.06
    assert KF >= 5 and system.graph.n_vertices == KF == len(system.kf_backend_ms)


def test_ring_on_card_within_sync_budget(dev, kernels):
    """The ring on the card: one read per frame (its row, with the blob of
    the keyframe the previous completion dispatched), one more per retry,
    loop closure and two per relocalization; the first frame is the serial
    initialisation (keyframe 0's blob), the flush reads the last row and the
    last keyframe's blob."""
    from rgbdslam_tpu_torch.eval.ate import ate_rmse

    ds, frames, system = _orbit_system(dev)
    kernels.reset_launch_counts()
    n, _ = _sync_calls(lambda: system.track_pipelined(*frames[0]))
    assert n == 1 and system.store.count == 1
    for f in frames[1:]:
        had_row = system.tracker._pipe is not None
        before = _counts(system)
        n, _ = _sync_calls(lambda: system.track_pipelined(*f))
        dE, _, dL, dR = _counts(system) - before
        assert n == int(had_row) + (dE - 1) + dL + 2 * dR, (n, dE, dL, dR)
    before = _counts(system)
    n, _ = _sync_calls(system.track_pipelined_flush)
    dE, dK, dL, dR = _counts(system) - before
    assert n == 1 + dK + dE + dL + 2 * dR
    system.finish()
    E, KF, R = system.tracker.stats.estimates, system.store.count, system.reloc_verifications
    assert kernels.LAUNCHES["detect_keypoints_fused"] == len(frames)
    assert kernels.LAUNCHES["hamming_match_2nn"] == E + 2 * KF + R
    assert kernels.LAUNCHES["ransac_se3_fused"] == E + KF + R
    assert kernels.LAUNCHES["gicp_refine_fused"] == E
    ts, poses = system.camera_trajectory()
    assert len(ts) == len(frames)
    assert ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)[0] < 0.06


def test_adaptive_batch_on_card(dev, kernels):
    """tests/test_extractor_cli.py's batched ADAPTIVE scenario on the card:
    9 frames from threshold 60, then 9 more. The run's first frame is
    re-detected on the host as in the JAX package (one read per round, the
    run's only waits); then the threshold evolves on the device (kernel A
    reads it from there), a later dispatch never waits, and the host
    extractor takes the last row's threshold at completion."""
    from rgbdslam_tpu_torch.config import ExtractorConfig, SlamConfig
    from rgbdslam_tpu_torch.geometry.camera import Camera
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.slam.tracking import Tracker

    cam = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
    cfg = SlamConfig(extractor=ExtractorConfig(num_features=128, num_levels=2, cell_size=8,
                                               fast_threshold=60.0, adapt_target_min=60,
                                               adapt_target_max=120),
                     adaptive=True)
    ds = SyntheticDataset(n_frames=48, cam=cam, trajectory="orbit", device=dev)
    frames = [ds.grab(i) for i in range(18)]
    tr = Tracker(cam, cfg, seed=0, device=dev)
    kernels.reset_launch_counts()
    n, h = _sync_calls(lambda: tr.track_batch_dispatch(*zip(*frames[:9])))
    reads = tr._extractor.reads
    # a detection per round of the first frame (the last round's unread
    # when the rounds run out), then one per frame
    assert reads >= 2 and n == reads
    assert kernels.LAUNCHES["detect_keypoints_fused"] - 8 in (reads, reads + 1)
    tr.track_batch_complete(h)
    assert tr._extractor.threshold < 60.0 * 0.7 + 1e-6
    assert tr._extractor.threshold >= tr._extractor.th_min - 1e-6
    kernels.reset_launch_counts()
    n, h = _sync_calls(lambda: tr.track_batch_dispatch(*zip(*frames[9:])))
    assert n == 0 and kernels.LAUNCHES["detect_keypoints_fused"] == 9
    tr.track_batch_complete(h)
