"""The merge, the Sim(3) LM, projection-guided matching and PnP RANSAC on
the card against their plain runs on the CPU (chip_smoke.py phase 12's
checks at test size). Every test here is marked `gpu` and skips without a
card:

  python -m pytest -q --noconftest -m gpu tests/test_torch_gpu_merge.py

Tolerances: the Sim(3) LM on a well-conditioned graph and sim3_ransac within
1e-4 of the CPU with equal inlier counts and success flags; the merge by
tests/test_merge.py's gates on the card, and its own joint graph through
the LM on the card and the CPU at the same float64 cost (1e-6 relative),
the poses within 2e-2: the graph has soft modes, the bending of session B's
open chain, along which the f32 solution moves by up to ~2e-3 with the
order of its sums (the edges reordered on the CPU) at the same cost, and
the whole merge on the card and on the CPU with the same draws came out
9.3e-3 apart at this size;
projection_match exact; pnp_ransac's pose within 1e-4 (5e-4 with DLT
hypotheses, whose f32 fits carry ~1e-3 of rounding) with the same injected
draws, inlier masks equal but on rows within 1e-3 px^2 of a gate (DLT: at
most 3 % of the rows apart), and no host synchronisation inside a call.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, SlamConfig
from rgbdslam_tpu_torch.frontend.frame import build_frame_features
from rgbdslam_tpu_torch.frontend.matcher import projection_match
from rgbdslam_tpu_torch.geometry import se3, sim3
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
from rgbdslam_tpu_torch.mapping import merge as merge_mod
from rgbdslam_tpu_torch.slam.system import SlamSystem
from rgbdslam_tpu_torch.solvers import pnp
from rgbdslam_tpu_torch.solvers.pose_graph import (PoseGraphEdges, optimize_sim3_graph,
                                                   sim3_graph_cost)
from rgbdslam_tpu_torch.solvers.ransac_se3 import draw_valid

pytestmark = pytest.mark.gpu

CAM = Camera(130.0, 130.0, 79.5, 59.5, width=160, height=120)
CFG = SlamConfig(
    extractor=ExtractorConfig(num_features=384, num_levels=3, cell_size=6,
                              fast_threshold=12.0, min_response=8.0, min_border=16),
    loop=LoopConfig(id_interval=12, min_kfs_since_loop=10))
PNP_CAM = Camera(525.0, 525.0, 319.5, 239.5)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _syncs(fn):
    """(host synchronisations torch reports while fn() runs, fn's result)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message).lower() for w in caught), out


@pytest.fixture(scope="module")
def sessions(dev):
    """Sessions A (tour frames 0-60) and B (52-112, depth x1.05) on the card."""
    ds = SyntheticDataset(n_frames=112, cam=CAM, trajectory="tour", device=dev)
    out = []
    for lo, hi, scale in ((0, 60, 1.0), (52, 112, 1.05)):
        system = SlamSystem(CAM, CFG, seed=0, device=dev)
        system.load_vocabulary(shipped_vocabulary("svo_fast"))
        for i in range(lo, hi):
            ts, g, z = ds.grab(i)
            system.track(ts, g, z * scale)
        system.finish()
        out.append(system)
    return out


def test_merge_on_the_card(sessions, monkeypatch):
    """tests/test_merge.py's gates on the card, and the merge's own joint
    graph through the Sim(3) LM on the card against the CPU: the same
    float64 cost (1e-6 relative), the poses within 2e-2 (the graph's soft
    modes, see the module docstring)."""
    sys_a, sys_b = sessions
    captured = []
    solve = merge_mod.optimize_sim3_graph

    def spy(*a):
        captured.append(a)
        return solve(*a)

    monkeypatch.setattr(merge_mod, "optimize_sim3_graph", spy)
    res = merge_mod.merge_maps(sys_a, sys_b, max_pairs=4, min_inliers=15)
    Ka = sys_a.store.count
    assert abs(np.median(res.scales[:Ka]) - 1.0) < 0.02
    assert abs(np.median(res.scales[Ka:]) - 1 / 1.05) < 0.02
    assert np.std(res.scales[Ka:]) < 0.02
    S, e, fixed, iters = captured[0]
    S_card, _ = solve(S, e, fixed, iters)
    e_cpu = PoseGraphEdges(*[t.cpu() for t in e])
    S_cpu, _ = solve(S.cpu(), e_cpu, fixed.cpu(), iters)
    e64 = PoseGraphEdges(e_cpu.a, e_cpu.b, e_cpu.Z.double(), e_cpu.weight.double())
    c_card, c_cpu = (float(sim3_graph_cost(x.double(), e64, 1.0)) for x in (S_card.cpu(), S_cpu))
    assert abs(c_card - c_cpu) <= 1e-6 * c_cpu, (c_card, c_cpu)
    np.testing.assert_allclose(S_card.cpu().numpy(), S_cpu.numpy(), atol=2e-2)


def test_merge_launches_k2_twice_a_pair(sessions):
    from rgbdslam_tpu_torch.ops import kernels

    sys_a, sys_b = sessions
    kernels.reset_launch_counts()
    res = merge_mod.merge_maps(sys_a, sys_b, max_pairs=4, min_inliers=15)
    assert kernels.LAUNCHES["hamming_match_2nn"] == res.tried
    assert kernels.LAUNCHES["match_gates"] == res.tried
    assert sum(kernels.LAUNCHES.values()) == 2 * res.tried


def _drift_graph(n=24, seed=0):
    rng = np.random.default_rng(seed)
    est = [np.eye(4, dtype=np.float32)]
    for _ in range(1, n):
        xi = np.r_[0.5, rng.normal(0, 0.05, 5), np.log(1.05)].astype(np.float32)
        est.append(est[-1] @ sim3.exp(torch.from_numpy(xi)).numpy())
    est = np.stack(est).astype(np.float32)
    a = list(range(1, n)) + [n - 1, n // 2]
    b = list(range(0, n - 1)) + [0, 0]
    Z = [sim3.inverse(torch.from_numpy(est[i])).numpy() @ est[j] for i, j in zip(a[:-2], b[:-2])]
    Z += [np.eye(4, dtype=np.float32)] * 2
    return (torch.from_numpy(est), torch.tensor(a), torch.tensor(b),
            torch.from_numpy(np.stack(Z).astype(np.float32)))


def test_sim3_lm_card_equals_cpu(dev):
    S, a, b, Z = _drift_graph()
    w = torch.full((a.shape[0],), 100.0)
    fixed = torch.zeros(S.shape[0], dtype=torch.bool)
    fixed[0] = True
    S_cpu, c_cpu = optimize_sim3_graph(S, PoseGraphEdges(a, b, Z, w), fixed, 12)
    on = [t.to(dev) for t in (S, a, b, Z, w, fixed)]
    n_sync, (S_card, c_card) = _syncs(lambda: optimize_sim3_graph(
        on[0], PoseGraphEdges(*on[1:5]), on[5], 12))
    assert n_sync == 0
    np.testing.assert_allclose(S_card.cpu().numpy(), S_cpu.numpy(), atol=1e-4)
    assert abs(float(c_card) - float(c_cpu)) <= 1e-4 * max(1.0, abs(float(c_cpu)))


def test_sim3_ransac_card_equals_cpu(dev):
    rng = np.random.default_rng(1)
    p1 = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    S = sim3.exp(torch.tensor([0.3, -0.2, 0.1, 0.05, -0.1, 0.2, float(np.log(1.05))]))
    p2 = sim3.transform_points(S, torch.from_numpy(p1)).numpy()
    p2 = p2 + rng.normal(0, 0.01, p2.shape).astype(np.float32)
    p2[:150] += rng.normal(0, 1.0, (150, 3)).astype(np.float32)
    valid = np.ones(512, bool)
    valid[::9] = False
    draws = draw_valid(torch.from_numpy(valid), 128, 4, torch.Generator().manual_seed(2))
    S_cpu, n_cpu, ok_cpu = merge_mod.sim3_ransac(
        torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid), draws=draws)
    on = [t.to(dev) for t in (torch.from_numpy(p1), torch.from_numpy(p2),
                              torch.from_numpy(valid), draws)]
    n_sync, (S_card, n_card, ok_card) = _syncs(lambda: merge_mod.sim3_ransac(
        *on[:3], draws=on[3]))
    assert n_sync == 0
    assert int(n_card) == int(n_cpu) and bool(ok_card) == bool(ok_cpu) and int(n_cpu) > 300
    np.testing.assert_allclose(S_card.cpu().numpy(), S_cpu.numpy(), atol=1e-4)


@pytest.fixture(scope="module")
def pair(dev):
    ds = SyntheticDataset(n_frames=112, cam=CAM, trajectory="tour", device=dev)
    f = [build_frame_features(CAM, *ds.grab(i)[1:], CFG.extractor) for i in (20, 22)]
    T21 = (np.linalg.inv(ds.poses_twc[22]) @ ds.poses_twc[20]).astype(np.float32)
    return f, torch.from_numpy(T21)


def _cpu(f):
    return dataclasses.replace(f, **{k.name: getattr(f, k.name).cpu()
                                     for k in dataclasses.fields(f)})


@pytest.mark.parametrize("prior", ["true", "wrong"])
def test_projection_match_card_equals_cpu(dev, pair, prior):
    (f0, f1), T21 = pair
    if prior == "wrong":
        T21 = torch.eye(4)
        T21[0, 3] = 1.5
    T21_card = T21.to(dev)
    n_sync, m_card = _syncs(lambda: projection_match(f0, f1, T21_card, CAM))
    m_cpu = projection_match(_cpu(f0), _cpu(f1), T21, CAM)
    assert n_sync == 0
    for a in ("idx2", "dist", "valid"):
        assert torch.equal(getattr(m_card, a).cpu(), getattr(m_cpu, a)), a
    assert int(m_cpu.valid.sum()) > (20 if prior == "true" else -1)


def _pnp_problem(seed=0, n=256, n_out=80):
    rng = np.random.default_rng(seed)
    Xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 6, n)],
                  axis=-1).astype(np.float32)
    Tcw = se3.exp(torch.tensor([0.2, -0.1, 0.3, 0.1, -0.2, 0.05])).numpy()
    Xc = Xw @ Tcw[:3, :3].T + Tcw[:3, 3]
    uv = np.stack([525 * Xc[:, 0] / Xc[:, 2] + 319.5, 525 * Xc[:, 1] / Xc[:, 2] + 239.5], -1)
    uv = (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)
    uv[rng.choice(n, n_out, replace=False)] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    valid = np.ones(n, bool)
    valid[::13] = False
    return torch.from_numpy(Xw), torch.from_numpy(uv), torch.from_numpy(valid), Tcw


@pytest.mark.parametrize("minimal", ["p3p", "epnp", "dlt6"])
@pytest.mark.parametrize("refit", ["ba", "epnp+ba"])
def test_pnp_ransac_card_equals_cpu(dev, minimal, refit):
    Xw, uv, valid, Tcw = _pnp_problem()
    draws = draw_valid(valid, pnp.PNP_HYPOTHESES, pnp.PNP_SAMPLE[minimal],
                       torch.Generator().manual_seed(3))
    r_cpu = pnp.pnp_ransac(PNP_CAM, Xw, uv, valid, minimal=minimal, refit=refit, draws=draws)
    on = [t.to(dev) for t in (Xw, uv, valid, draws)]

    def call():
        return pnp.pnp_ransac(PNP_CAM, *on[:3], minimal=minimal, refit=refit, draws=on[3])

    call()          # first use: the per-device constants go up once
    n_sync, r_card = _syncs(call)
    assert n_sync == 0
    assert bool(r_card.success) == bool(r_cpu.success) and bool(r_cpu.success)
    tol = 5e-4 if minimal == "dlt6" else 1e-4
    np.testing.assert_allclose(r_card.Tcw.cpu().numpy(), r_cpu.Tcw.numpy(), atol=tol)
    res = pnp.reproj_residuals(PNP_CAM, r_card.Tcw.cpu(), Xw, uv)
    e2 = torch.sum(res * res, dim=-1)
    near = (torch.abs(e2 - 9.0) <= 1e-3) | (torch.abs(e2 - pnp.CHI2_TH) <= 1e-3)
    differ = r_card.inliers.cpu() != r_cpu.inliers
    if minimal == "dlt6":
        assert int(differ.sum()) <= 0.03 * Xw.shape[0]
    else:
        assert not bool((differ & ~near).any())
    assert np.linalg.norm((np.linalg.inv(r_card.Tcw.cpu().numpy()) @ Tcw)[:3, 3]) < 0.02


def test_eigh_jacobi_card_equals_cpu(dev):
    g = torch.Generator().manual_seed(4)
    X = torch.randn((256, 24, 12), generator=g)
    A = X.transpose(-1, -2) @ X
    e_cpu, v_cpu = pnp.eigh_jacobi(A)
    A_card = A.to(dev)
    n_sync, (e_card, v_card) = _syncs(lambda: pnp.eigh_jacobi(A_card))
    assert n_sync == 0
    scale = e_cpu.abs().amax(-1, keepdim=True)
    assert float(((e_card.cpu() - e_cpu).abs() / scale).max()) < 1e-5
    # eigenvectors of near-equal eigenvalues are not determined one by one:
    # hold the card's decomposition by what it reconstructs and orthonormality
    V = v_card.cpu()
    rec = V @ torch.diag_embed(e_card.cpu()) @ V.transpose(-1, -2)
    assert float(((rec - A).abs().amax((-2, -1)) / scale[:, 0]).max()) < 1e-5
    eye = torch.eye(12).expand(V.shape)
    assert float((V.transpose(-1, -2) @ V - eye).abs().max()) < 1e-5
    # the signs are canonical: an eigenvector whose eigenvalue lies 1e-3 of
    # the largest from its neighbours is the CPU's, sign included
    gap = torch.full_like(e_cpu, float("inf"))
    step = (e_cpu[..., 1:] - e_cpu[..., :-1]) / scale
    gap[..., 1:] = torch.minimum(gap[..., 1:], step)
    gap[..., :-1] = torch.minimum(gap[..., :-1], step)
    d = torch.linalg.vector_norm(V - v_cpu, dim=-2)
    assert float(d[gap > 1e-3].max()) < 1e-3


def test_distributed_flag_on_the_card(dev):
    cfg = dataclasses.replace(CFG, distributed=True)
    system = SlamSystem(CAM, cfg, device=dev)
    if torch.cuda.device_count() > 1:
        # several cards: the solves ride a mesh over all of them
        assert system.graph.mesh.size == torch.cuda.device_count()
        return
    assert system.graph.mesh is None
