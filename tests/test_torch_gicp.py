"""GICP (K4's plain version, gicp_refine) and depth-patch covariances of
rgbdslam_tpu_torch against rgbdslam_tpu on the same numpy inputs.

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

jicp = importlib.import_module("rgbdslam_tpu.solvers.icp")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once; a torch process that takes
    every core for its intra-op threads then spends its time waiting for
    them. Two threads per process keep the workers out of each other's way."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
        assert kernels.LAUNCHES["gicp_refine_kernel"] == 0   # CPU: plain loop
        assert bool(ct) == bool(cj)
        assert int(nt) == int(nj)
        np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-4, atol=1e-5)
    assert not bool(ct)
    np.testing.assert_array_equal(Tt.numpy(), T0)          # fallback keeps T_init
    with pytest.raises(NotImplementedError):
        ticp.gicp_refine(*_t(p1, p2, valid, T0), IcpConfig(reassociate=True), *_t(C1, C2))


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
    assert kernels.LAUNCHES["gicp_refine_kernel"] == 0       # CPU: plain loop
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
