"""GICP (K4's plain version, gicp_refine, a model of the fused kernel) and
depth-patch covariances of rgbdslam_tpu_torch against rgbdslam_tpu on the
same numpy inputs.

Poses are held to the JAX kernel test's tolerance (rtol 1e-4, atol 1e-5,
tests/test_pallas_ransac.py:149-150): ten Gauss-Newton rounds of f32
reductions summed in different orders, and a Cholesky (Pallas) against an
LU solve (XLA, the port).

On rendered frames the one-pass depth-patch covariances come out slightly
indefinite, the 6x6 system too, and the Pallas kernel's unpivoted Cholesky
returns NaN there. The port solves by pivoted elimination like the XLA
path (LU), so on those inputs it is held to the XLA loop, and the Pallas
kernel's NaN is pinned as the reason.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.config import ExtractorConfig as JExtractorConfig
from rgbdslam_tpu.config import IcpConfig as JIcpConfig
from rgbdslam_tpu.config import SlamConfig as JSlamConfig
from rgbdslam_tpu.frontend.frame import build_frame_features as j_build
from rgbdslam_tpu.frontend.matcher import gather_matched_points as j_gather
from rgbdslam_tpu.frontend.matcher import match_frames as j_match
from rgbdslam_tpu.geometry import camera as jcam
from rgbdslam_tpu.geometry import se3 as jse3
from rgbdslam_tpu.io.synthetic import SyntheticDataset
from rgbdslam_tpu.solvers.ransac_se3 import ransac_se3 as j_ransac
from rgbdslam_tpu.ops.pallas_kernels import gicp_refine_kernel as j_gicp_kernel
from rgbdslam_tpu_torch.config import IcpConfig
from rgbdslam_tpu_torch.geometry import camera as tcam
from rgbdslam_tpu_torch.ops import kernels
from rgbdslam_tpu_torch.solvers import icp as ticp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

jicp = importlib.import_module("rgbdslam_tpu.solvers.icp")


def _problem(seed, N=256, noise=0.004):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    p1[:, 2] += 2.5
    T = np.asarray(jse3.exp(jnp.asarray(rng.normal(scale=0.03, size=6).astype(np.float32))))
    p2 = (p1 @ T[:3, :3].T + T[:3, 3] + rng.normal(scale=noise, size=(N, 3))).astype(np.float32)
    A = rng.normal(scale=0.02, size=(N, 3, 3)).astype(np.float32)
    C1 = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    B = rng.normal(scale=0.02, size=(N, 3, 3)).astype(np.float32)
    C2 = B @ B.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    valid = rng.uniform(size=N) > 0.2
    T0 = np.asarray(jse3.exp(jnp.asarray(rng.normal(scale=0.02, size=6).astype(np.float32)))) @ T
    return T0.astype(np.float32), p1, p2, C1, C2, valid, T


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed,iters,N", [(6, 10, 1024)])   # the main path's shape
def test_gicp_ref_matches_pallas_kernel_and_xla_loop(seed, iters, N):
    T0, p1, p2, C1, C2, valid, T = _problem(seed, N)
    md = 0.15
    Tk, cost_k, cnt_k = j_gicp_kernel(*(jnp.asarray(a) for a in (T0, p1, p2, C1, C2, valid)),
                                      iters, md, interpret=True)
    Tx, conv_x, _ = jicp.gicp_refine(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                                     jnp.asarray(T0), None,
                                     JIcpConfig(max_iterations=iters, max_correspondence_dist=md),
                                     C1=jnp.asarray(C1), C2=jnp.asarray(C2))
    assert bool(conv_x)
    Tp, cost_p, cnt_p = kernels.gicp_refine_ref(*_t(T0, p1, p2, C1, C2, valid), iters, md)
    for ref in (np.asarray(Tk), np.asarray(Tx)):
        np.testing.assert_allclose(Tp.numpy(), ref, rtol=1e-4, atol=1e-5)
    # last round's gated count and cost: the kernel gates |r|^2 < d^2, the
    # plain loop |r| < d (one pair on the boundary at most), cost f32 sums
    assert abs(float(cnt_p) - float(cnt_k)) <= 1.0
    np.testing.assert_allclose(float(cost_p), float(cost_k), rtol=1e-3)
    assert np.linalg.norm(Tp.numpy()[:3, 3] - T[:3, 3]) < 5e-3


def test_gicp_refine_matches_jax_and_falls_back():
    T0, p1, p2, C1, C2, valid, _ = _problem(7)
    for nvalid in (None, 10):
        v = valid.copy()
        if nvalid is not None:
            v[np.flatnonzero(v)[nvalid:]] = False          # under-constrained
        Tj, cj, nj = jicp.gicp_refine(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(v),
                                      jnp.asarray(T0), None, JIcpConfig(),
                                      C1=jnp.asarray(C1), C2=jnp.asarray(C2))
        kernels.reset_launch_counts()
        Tt, ct, nt = ticp.gicp_refine(*_t(p1, p2, v, T0), IcpConfig(), *_t(C1, C2))
        assert kernels.LAUNCHES["gicp_refine_fused"] == 0    # CPU: plain loop
        assert bool(ct) == bool(cj)
        assert int(nt) == int(nj)
        np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-4, atol=1e-5)
    assert not bool(ct)
    np.testing.assert_array_equal(Tt.numpy(), T0)          # fallback keeps T_init
    # reassociating GICP runs too, and agrees with the JAX package's loop
    cfg = dict(reassociate=True, max_correspondence_dist=0.15)
    Tj, cj, nj = jicp.gicp_refine(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                                  jnp.asarray(T0), None, JIcpConfig(**cfg),
                                  C1=jnp.asarray(C1), C2=jnp.asarray(C2))
    Tt, ct, nt = ticp.gicp_refine(*_t(p1, p2, valid, T0), IcpConfig(**cfg), *_t(C1, C2))
    assert bool(ct) == bool(cj) and int(nt) == int(nj) and bool(ct)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-4, atol=1e-5)


def test_depth_patch_covariances_match_jax():
    cam_j = jcam.Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
    cam_t = tcam.Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
    _, _, depth = SyntheticDataset(n_frames=24, cam=cam_j, trajectory="sweep").grab(2)
    depth = np.array(depth)
    depth[100:110, 100:140] = 0.0                           # invalid-depth holes
    rng = np.random.default_rng(8)
    uv = rng.integers(0, [320, 240], size=(512, 2)).astype(np.float32)
    a = np.asarray(jicp.depth_patch_covariances(cam_j, jnp.asarray(depth), jnp.asarray(uv)))
    b = ticp.depth_patch_covariances(cam_t, *_t(depth, uv)).numpy()
    # the one-pass moments E[zz] - E[z]^2 cancel: at z ~ 4 m a 25-pixel sum
    # of z^2 is ~400, whose f32 ulp (3e-5) is 1.2e-6 after the division by
    # 25; reduce_window and the separable box sum add in different orders
    # and differ by up to ~10 such ulps, the absolute error the covariances
    # inherit
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=2e-5)


@pytest.fixture(scope="module")
def rendered_pairs():
    """GICP inputs of the first frame pairs of the 320x240 sweep, built by
    the JAX package: matched points, RANSAC inliers and T21, and the
    depth-patch covariances of both frames (JAX-rendered frames)."""
    cam = jcam.Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
    cfg = JSlamConfig(extractor=JExtractorConfig(num_features=1024, num_levels=3,
                                                 cell_size=8, fast_threshold=15.0))
    ds = SyntheticDataset(n_frames=24, cam=cam, trajectory="sweep")
    feats = [j_build(cam, *(jnp.asarray(x) for x in ds.grab(i)[1:]), cfg.extractor)
             for i in range(5)]
    key = jax.random.PRNGKey(0)
    pairs = []
    for fa, fb in zip(feats[:-1], feats[1:]):
        m = j_match(fa, fb, cfg.matcher.nn_ratio)
        p1, p2, w, valid = j_gather(fa, fb, m)
        key, sub = jax.random.split(key)
        res = j_ransac(p1, p2, w, valid, sub, cfg.ransac)
        pairs.append(tuple(np.array(a) for a in (
            res.T21, p1, p2, fa.surf_cov, fb.surf_cov[m.idx2], res.inliers)))
    return cfg.icp, pairs


# Pair 0 (frames 0 -> 1) is the worst-conditioned: its first-round H has
# eigenvalues from -1.2e6 to 8.7e9 (condition 5.8e4, float64 analysis of the
# same inputs). There the two LU loops, whose f32 reductions add in
# different orders, differ by 2e-7 after one round and by 2.6e-5 after ten:
# the rounding of each round is amplified by the condition number and fed
# to the next. Its bound is that growth with 2x headroom; the other pairs
# (condition 1e2-3e3) are held to the module's tolerance.
@pytest.mark.parametrize("pair,atol", [(0, 5e-5), (1, 1e-5), (2, 1e-5), (3, 1e-5)])
def test_gicp_refine_matches_xla_on_indefinite_rendered_covariances(rendered_pairs, pair,
                                                                     atol):
    icp_cfg, pairs = rendered_pairs
    T0, p1, p2, C1, C2, inl = pairs[pair]
    # the inputs are indefinite: C1 + C2 has a negative eigenvalue on some
    # of the inlier pairs (f32 one-pass moments at ~4 m)
    S = C1.astype(np.float64) + C2.astype(np.float64)
    assert inl.sum() > 100
    assert np.linalg.eigvalsh(S[inl])[:, 0].min() < 0.0
    # the reference's fault the port works around: the Pallas kernel's
    # Cholesky returns NaN on them
    Tk, _, _ = j_gicp_kernel(*(jnp.asarray(a) for a in (T0, p1, p2, C1, C2, inl)),
                             icp_cfg.max_iterations, icp_cfg.max_correspondence_dist,
                             interpret=True)
    assert not np.isfinite(np.asarray(Tk)).all()
    # the port's plain LU loop against the XLA loop (jnp.linalg.solve)
    Tx, cx, nx = jicp.gicp_refine(*(jnp.asarray(a) for a in (p1, p2, inl, T0)), None,
                                  JIcpConfig(), C1=jnp.asarray(C1), C2=jnp.asarray(C2))
    kernels.reset_launch_counts()
    Tt, ct, nt = ticp.gicp_refine(*_t(p1, p2, inl, T0), IcpConfig(), *_t(C1, C2))
    assert kernels.LAUNCHES["gicp_refine_fused"] == 0        # CPU: plain loop
    assert bool(cx) and bool(ct)
    assert int(nt) == int(nx)
    assert np.isfinite(Tt.numpy()).all()
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tx), rtol=1e-4, atol=atol)


@pytest.mark.parametrize("seed,N,md", [(3, 256, 0.15), (8, 1024, 0.07), (9, 64, 0.1)])
def test_gicp_gn_normal_equations_ref_matches_pallas_kernel(seed, N, md):
    """K5's plain version against the JAX package's kernel in interpret
    mode: H and b rtol 1e-5 on the scale of max|H| (f32 sums of N terms in
    another order), the cost rtol 1e-4, the gated count exact."""
    from rgbdslam_tpu.ops.pallas_kernels import gicp_gn_normal_equations as j_gn

    T0, p1, p2, C1, C2, valid, _ = _problem(seed, N)
    Hj, bj, cj, nj = j_gn(*(jnp.asarray(a) for a in (T0, p1, p2, C1, C2, valid)), md,
                          interpret=True)
    Ht, bt, ct, nt = kernels.gicp_gn_normal_equations_ref(*_t(T0, p1, p2, C1, C2, valid), md)
    scale = float(np.abs(np.asarray(Hj)).max())
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)
    assert int(nt) == int(nj) and 0 < int(nt) <= int(valid.sum())
    assert torch.equal(Ht, Ht.T) or float((Ht - Ht.T).abs().max()) <= 1e-6 * scale


def test_gicp_gn_build_is_one_round_of_the_loop():
    """exp(solve(H + 1e-6 I, -b)) @ T0 is the plain loop's first round
    (K4's plain version at iters=1), and the build's cost and count are the
    ones that round reports."""
    from rgbdslam_tpu_torch.geometry import se3 as tse3

    T0, p1, p2, C1, C2, valid, _ = _problem(4, 512)
    args = _t(T0, p1, p2, C1, C2, valid)
    H, b, cost, cnt = kernels.gicp_gn_normal_equations_ref(*args, 0.07)
    T1, c1, n1 = kernels.gicp_refine_ref(*args, 1, 0.07)
    xi = torch.linalg.solve(H.double() + 1e-6 * torch.eye(6, dtype=torch.float64), -b.double())
    T_ref = (tse3.exp(xi) @ args[0].double()).float()
    torch.testing.assert_close(T1, T_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(c1, cost, rtol=1e-4, atol=1e-6)
    assert abs(float(n1) - float(cnt)) <= 1.0     # |r| < d against |r|^2 < d^2
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gicp_gn_normal_equations(*args, 0.07)
    assert kernels.LAUNCHES["gicp_gn_normal_equations"] == 0


# ---------------------------------------------------------------------------
# a model of the fused kernel (csrc/gicp.cu): its sums in its order, its gate
# ---------------------------------------------------------------------------

K_THREADS, K_SUMS = 512, 29


def _tri6(i, j):
    return i * 6 - i * (i - 1) // 2 + (j - i)


def _model_point_sums(R, t, p1, p2, C1, C2, valid, max_dist2):
    """(N, 29) contributions of every correspondence, in the kernel's
    arithmetic: S = R C1 R^T + C2 from the upper triangles, W by adjugate,
    the gate |r|^2 < max_dist^2, the Jacobian's constant entries left out."""
    q = p1 @ R.T + t
    r = q - p2
    dist2 = (r * r).sum(-1)
    sym1 = torch.triu(C1) + torch.triu(C1, 1).transpose(1, 2)   # the upper triangle, mirrored
    sym2 = torch.triu(C2) + torch.triu(C2, 1).transpose(1, 2)
    S = torch.einsum("ik,jl,nkl->nij", R, R, sym1) + sym2
    a, b, c = S[:, 0, 0], S[:, 0, 1], S[:, 0, 2]
    d, e, f = S[:, 1, 1], S[:, 1, 2], S[:, 2, 2]
    A11, A12, A13 = d * f - e * e, c * e - b * f, b * e - c * d
    A22, A23, A33 = a * f - c * c, b * c - a * e, a * d - b * b
    det = a * A11 + b * A12 + c * A13
    inv = 1.0 / torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    W = torch.stack([torch.stack([A11, A12, A13], -1), torch.stack([A12, A22, A23], -1),
                     torch.stack([A13, A23, A33], -1)], -2) * inv[:, None, None]
    gate = (valid & (dist2 < max_dist2)).to(torch.float32)
    zero = torch.zeros_like(q[:, 0])
    hat_cols = [torch.stack([zero, -q[:, 2], q[:, 1]], -1),
                torch.stack([q[:, 2], zero, -q[:, 0]], -1),
                torch.stack([-q[:, 1], q[:, 0], zero], -1)]
    cols = [torch.eye(3)[k].expand(q.shape[0], 3) for k in range(3)] + hat_cols
    Wc = [torch.einsum("nij,nj->ni", W, cj) for cj in cols]
    out = torch.zeros((q.shape[0], K_SUMS))
    for i in range(6):
        for j in range(i, 6):
            out[:, _tri6(i, j)] = (cols[i] * Wc[j]).sum(-1) * gate
        out[:, 21 + i] = (Wc[i] * r).sum(-1) * gate
    out[:, 27] = (r * torch.einsum("nij,nj->ni", W, r)).sum(-1) * gate
    out[:, 28] = gate
    return out


def _model_block_sum(contrib):
    """The block's sum in the kernel's order: thread t adds points t, t + 512,
    ... in turn; a warp adds lanes i and i + 16, then + 8, ... + 1; the 16
    warps' partials are added in warp order."""
    n = contrib.shape[0]
    rounds = -(-n // K_THREADS)
    padded = torch.zeros((rounds * K_THREADS, K_SUMS))
    padded[:n] = contrib
    acc = torch.zeros((K_THREADS, K_SUMS))
    for k in range(rounds):
        acc = acc + padded[k * K_THREADS:(k + 1) * K_THREADS]
    x = acc.reshape(K_THREADS // 32, 32, K_SUMS)
    for half in (16, 8, 4, 2, 1):
        x = x[:, :half] + x[:, half:2 * half]
    total = x[0, 0]
    for w in range(1, K_THREADS // 32):
        total = total + x[w, 0]
    return total


def _model_nearest(q, p2, valid):
    """nearest_target of csrc/gicp.cu, point by point: a scan over the valid
    targets with d = (dx^2 + dy^2) + dz^2, the first strict minimum kept, a
    NaN taken once and then kept, 0 where nothing is nearer than +inf."""
    out = torch.zeros(q.shape[0], dtype=torch.int64)
    for i in range(q.shape[0]):
        d = q[i] - p2
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        best, bd = 0, float("inf")
        for j in torch.nonzero(valid)[:, 0].tolist():
            v = float(d2[j])
            if not np.isnan(bd) and (v < bd or np.isnan(v)):
                best, bd = j, v
        out[i] = best
    return out


def _model_gicp_refine_fused(T_init, p1, p2, C1, C2, valid, iters, max_dist, min_matches,
                             reassociate=False):
    """((T_out, converged, n_valid), T_fin): the loop on the model's sums,
    the pivoted solve, the exp-compose, then the kernel's gate: both counts
    >= min_matches at the final pose (|r| < max_dist by the square root) and
    a finite pose, else T_init. With `reassociate` every round and the gate
    pair each point with its nearest valid target first."""
    from rgbdslam_tpu_torch.geometry import se3 as tse3

    def paired(T):
        if not reassociate:
            return p2, C2
        R, t = T[:3, :3], T[:3, 3]
        q = torch.stack([R[i, 0] * p1[:, 0] + R[i, 1] * p1[:, 1] + R[i, 2] * p1[:, 2] + t[i]
                         for i in range(3)], -1)
        j = _model_nearest(q, p2, valid)
        return p2[j], C2[j]

    T = T_init.clone()
    for _ in range(iters):
        p2_i, C2_i = paired(T)
        sums = _model_block_sum(_model_point_sums(T[:3, :3], T[:3, 3], p1, p2_i, C1, C2_i,
                                                  valid, np.float32(max_dist * max_dist)))
        H = torch.zeros((6, 6))
        for i in range(6):
            for j in range(i, 6):
                H[i, j] = H[j, i] = sums[_tri6(i, j)]
        H = H + 1e-6 * torch.eye(6)
        xi = -torch.linalg.solve_ex(H, sums[21:27, None])[0][:, 0]
        T = tse3.exp(xi) @ T
    q = p1 @ T[:3, :3].T + T[:3, 3]
    n_valid = int(valid.sum())
    p2_f = paired(T)[0] if bool(torch.isfinite(T).all()) else p2
    n_gated = int((valid & (torch.sqrt(((q - p2_f) ** 2).sum(-1)) < max_dist)).sum())
    converged = (n_valid >= min_matches and n_gated >= min_matches
                 and bool(torch.isfinite(T[:3]).all()))
    return (T if converged else T_init, converged, n_valid), T


@pytest.mark.parametrize("case", ["plain", "1024 points", "too few valid pairs",
                                  "non-finite final pose", "pairs out of reach",
                                  "reassociating", "reassociating bad pairs"])
def test_fused_gicp_model_matches_plain_and_jax(case):
    """The fused kernel's algorithm (sums in its thread, warp and block
    order, solve, compose, gate, fallback) against the plain loop + gate and
    the JAX gicp_refine: converged and n_valid exact, poses rtol 1e-4 / atol
    1e-5 (f32 sums in three different orders over ten rounds)."""
    T0, p1, p2, C1, C2, valid, _ = _problem(12, 1024 if case == "1024 points" else 300)
    reassoc = case.startswith("reassociating")
    cfg_kw = dict(max_iterations=10, max_correspondence_dist=0.15, min_matches=20,
                  reassociate=reassoc)
    if case == "reassociating bad pairs":         # wrong descriptor pairings
        p2[:60] = np.roll(p2[:60], 1, axis=0)
    if case == "too few valid pairs":
        valid[np.flatnonzero(valid)[19:]] = False
    elif case == "non-finite final pose":
        p1[np.flatnonzero(valid)[0]] = np.inf
    elif case == "pairs out of reach":
        p2 = p2 + np.float32(1.0)
    args = _t(T0, p1, p2, C1, C2, valid)
    (mT, mconv, mnv), mfin = _model_gicp_refine_fused(*args, 10, 0.15, 20, reassoc)
    pfin = kernels.gicp_refine_ref(*args, 10, 0.15, reassociate=reassoc)[0]
    pT, pconv, pnv = ticp._finish_gicp(pfin, args[0], args[1], args[2], args[5],
                                       IcpConfig(**cfg_kw))
    Tj, cj, nj = jicp.gicp_refine(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                                  jnp.asarray(T0), None, JIcpConfig(**cfg_kw),
                                  C1=jnp.asarray(C1), C2=jnp.asarray(C2))
    assert mconv == bool(pconv) == bool(cj)
    assert mnv == int(pnv) == int(nj)
    assert mconv == (case in ("plain", "1024 points") or reassoc)
    if case == "non-finite final pose":
        assert not np.isfinite(mfin.numpy()).all() and not np.isfinite(pfin.numpy()).all()
    else:
        np.testing.assert_allclose(mfin.numpy(), pfin.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mT.numpy(), pT.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mT.numpy(), np.asarray(Tj), rtol=1e-4, atol=1e-5)
    if not mconv:
        np.testing.assert_array_equal(mT.numpy(), T0)          # the fallback keeps T_init
        np.testing.assert_array_equal(pT.numpy(), T0)


def test_fused_gicp_wrapper_checks():
    """The fused wrapper takes CUDA tensors only; its kernel holds up to
    GICP_SHARED_POINTS correspondences' planes in shared memory (past them in
    global memory)."""
    T0, p1, p2, C1, C2, valid, _ = _problem(13, 64)
    args = _t(T0, p1, p2, C1, C2, valid)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gicp_refine_fused(*args, 10, 0.07, 20)
    assert kernels.LAUNCHES["gicp_refine_fused"] == 0
    assert kernels.GICP_SHARED_POINTS * 76 + 76 + 2032 <= 232448   # planes + static shared
