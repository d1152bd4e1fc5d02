"""K3's scorer alone (csrc/mahal.cu `mahal_scores_kernel`) and K5
(csrc/gicp.cu `gicp_gn_kernel`) on the card, against their plain PyTorch
versions. Every test here is marked `gpu` and skips without a card:

  python -m pytest -q --noconftest -m gpu tests/test_torch_gpu_scorer_gn.py

Tolerances are tests/test_torch_gpu.py's: counts exact (-fmad=false: each
m^2 rounds as the plain version's), the scorer's sums rtol 1e-5 / atol 1e-4
(another summation order), K5's H and b within 1e-5 of max|H|, its cost rtol
1e-4, its count exact. Both kernels sum in a fixed order: two calls give the
same bits. Each call is one device launch and, for K5, no other device op
(torch.profiler).
"""

import pytest
import torch

pytestmark = pytest.mark.gpu

TH = 9.0


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def kernels(dev):
    from rgbdslam_tpu_torch.ops import kernels as k

    return k


def _device_ops(fn, reps=8):
    """Windows of torch.profiler over `reps` calls of fn(), at most six:
    each window's {device op name: count} (kernels, copies and fills). The
    tracer drops records now and then, so a window short of launches is
    taken again; the first window with a count equal to the calls for every
    op ends the search."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    windows = []
    for _ in range(6):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = {}
        for evt in prof.key_averages():
            if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
                ops[evt.key] = ops.get(evt.key, 0) + evt.count
        windows.append(ops)
        if ops and all(c == reps for c in ops.values()):
            break
    return windows


def _assert_one_launch(fn, kernel_name, reps=8):
    """Every window holds the one kernel and no other device op, never more
    than one launch a call, and at least half of them (dropped records); at
    least one window holds exactly one a call."""
    windows = _device_ops(fn, reps)
    for ops in windows:
        assert len(ops) == 1, f"device ops besides {kernel_name}: {ops}"
        (name, count), = ops.items()
        assert kernel_name in name and 2 * count >= reps and count <= reps, windows
    assert any(next(iter(ops.values())) == reps for ops in windows), windows


def _scorer_problem(dev, seed, H, N, lead=()):
    from rgbdslam_tpu_torch.config import RansacConfig
    from rgbdslam_tpu_torch.geometry import se3
    from rgbdslam_tpu_torch.solvers.ransac_se3 import _sigma_diag

    g = torch.Generator(device=dev).manual_seed(seed)
    T_true = se3.exp(0.05 * torch.randn(6, generator=g, device=dev))
    T_h = (se3.exp(0.05 * torch.randn(lead + (H, 6), generator=g, device=dev)) @ T_true)
    T_h[..., 0, :, :] = T_true
    T_h = T_h.contiguous()
    p1 = torch.rand(lead + (N, 3), generator=g, device=dev) * 2 - 1
    p1[..., 2] = 0.5 + 3.5 * torch.rand(lead + (N,), generator=g, device=dev)
    p2 = (p1 @ T_true[:3, :3].T + T_true[:3, 3]
          + 0.005 * torch.randn(lead + (N, 3), generator=g, device=dev)).contiguous()
    valid = torch.rand(lead + (N,), generator=g, device=dev) > 0.2
    cfg = RansacConfig()
    s1 = _sigma_diag(p1[..., 2], cfg).contiguous()
    s2 = _sigma_diag(p2[..., 2], cfg).contiguous()
    return [T_h, p1.contiguous(), p2, s1, s2, valid]


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("N", [0, 1, 300, 1024, 4097, 8192])
@pytest.mark.parametrize("H", [1, 31, 256])
def test_scorer_matches_plain(dev, kernels, H, N):
    """Counts exact, sums rtol 1e-5 / atol 1e-4; a NaN hypothesis scores 0
    and 0.0; a second call gives the same bits."""
    args = _scorer_problem(dev, H + N, H, N)
    if H > 1:
        args[0][H // 2] = float("nan")
    kc, ke = kernels.mahal_hypothesis_scores(*args, TH)
    pc, pe = kernels.mahal_hypothesis_scores_ref(*args, TH)
    assert kc.shape == (H,) and kc.dtype == torch.int32 and ke.dtype == torch.float32
    assert torch.equal(kc, pc)
    torch.testing.assert_close(ke, pe, rtol=1e-5, atol=1e-4)
    if N >= 300:
        assert int(kc[0]) > N // 2
    if H > 1:
        assert int(kc[H // 2]) == 0 and float(ke[H // 2]) == 0.0
    if N == 0:
        assert int(kc.abs().sum()) == 0 and float(ke.abs().sum()) == 0.0
    assert _same_bits((kc, ke), kernels.mahal_hypothesis_scores(*args, TH))


@pytest.mark.parametrize("N", [1024, 4097, 8192])
def test_scorer_batch_of_13_matches_plain(dev, kernels, N):
    """13 problems in one launch, entries 3 and 11 all invalid: counts
    exact, sums rtol 1e-5 / atol 1e-4, the empty entries 0 and 0.0, entry b
    bit-equal to the unbatched call on it, a second call the same bits."""
    args = _scorer_problem(dev, N, 256, N, lead=(13,))
    args[5][3] = False
    args[5][11] = False
    kc, ke = kernels.mahal_hypothesis_scores(*args, TH)
    pc, pe = kernels.mahal_hypothesis_scores_ref(*args, TH)
    assert kc.shape == (13, 256) and torch.equal(kc, pc)
    torch.testing.assert_close(ke, pe, rtol=1e-5, atol=1e-4)
    for b in (3, 11):
        assert int(kc[b].sum()) == 0 and float(ke[b].abs().sum()) == 0.0
    assert int(kc[0, 0]) > N // 2
    for b in (0, 5, 12):
        one = kernels.mahal_hypothesis_scores(*(a[b].contiguous() for a in args), TH)
        assert _same_bits(one, (kc[b], ke[b]))
    assert _same_bits((kc, ke), kernels.mahal_hypothesis_scores(*args, TH))


@pytest.mark.parametrize("lead", [(), (13,)])
def test_scorer_is_one_launch(dev, kernels, lead):
    """One device launch a call, unbatched and at batch 13 (the smoke's
    shapes), and one count on the wrapper."""
    args = _scorer_problem(dev, 3, 256, 1024, lead=lead)
    kernels.reset_launch_counts()
    kernels.mahal_hypothesis_scores(*args, TH)
    assert kernels.LAUNCHES["mahal_hypothesis_scores"] == 1
    assert kernels.BATCHED_LAUNCHES["mahal_hypothesis_scores"] == int(bool(lead))
    _assert_one_launch(lambda: kernels.mahal_hypothesis_scores(*args, TH), "mahal_scores_kernel")


def _gicp_problem(dev, seed, N):
    from rgbdslam_tpu_torch.geometry import se3

    g = torch.Generator(device=dev).manual_seed(seed)
    p1 = torch.rand(N, 3, generator=g, device=dev) * 2 - 1
    p1[:, 2] += 2.5
    T = se3.exp(0.03 * torch.randn(6, generator=g, device=dev))
    p2 = p1 @ T[:3, :3].T + T[:3, 3] + 0.004 * torch.randn(N, 3, generator=g, device=dev)
    A = 0.02 * torch.randn(N, 3, 3, generator=g, device=dev)
    C1 = (A @ A.transpose(1, 2) + 1e-4 * torch.eye(3, device=dev)).contiguous()
    B = 0.02 * torch.randn(N, 3, 3, generator=g, device=dev)
    C2 = (B @ B.transpose(1, 2) + 1e-4 * torch.eye(3, device=dev)).contiguous()
    valid = torch.rand(N, generator=g, device=dev) > 0.2
    # a start within ~2 cm of the motion: most valid pairs pass the 7 cm gate
    T0 = (se3.exp(0.005 * torch.randn(6, generator=g, device=dev)) @ T).contiguous()
    return T0, p1, p2.contiguous(), C1, C2, valid


@pytest.mark.parametrize("N", [8, 300, 1000, 1024, 4097, 8192])
def test_k5_matches_plain(dev, kernels, N):
    """H and b within 1e-5 of max|H|, cost rtol 1e-4, count exact, H equal
    to H^T bit for bit, the outputs views of one buffer, a second call the
    same bits."""
    args = _gicp_problem(dev, N, N)
    kH, kb, kc, kn = kernels.gicp_gn_normal_equations(*args, 0.07)
    pH, pb, pc, pn = kernels.gicp_gn_normal_equations_ref(*args, 0.07)
    scale = float(pH.abs().max())
    assert float((kH - pH).abs().max()) <= 1e-5 * scale
    assert float((kb - pb).abs().max()) <= 1e-5 * scale
    torch.testing.assert_close(kc, pc, rtol=1e-4, atol=1e-6)
    assert float(kn) == float(pn) and float(kn) > (0.5 * N if N >= 300 else 0)
    assert torch.equal(kH, kH.T)
    assert kb.data_ptr() == kH.data_ptr() + 36 * 4 and kn.data_ptr() == kH.data_ptr() + 43 * 4
    assert _same_bits((kH, kb, kc, kn), kernels.gicp_gn_normal_equations(*args, 0.07))


def test_k5_is_one_launch_and_no_other_op(dev, kernels):
    """One device launch a call at N = 1024 and no fill, index or copy
    kernel beside it; one count on the wrapper."""
    args = _gicp_problem(dev, 5, 1024)
    kernels.reset_launch_counts()
    kernels.gicp_gn_normal_equations(*args, 0.07)
    assert kernels.LAUNCHES["gicp_gn_normal_equations"] == 1
    _assert_one_launch(lambda: kernels.gicp_gn_normal_equations(*args, 0.07), "gicp_gn_kernel")
