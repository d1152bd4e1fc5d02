"""Horn fit, Mahalanobis scoring (K3's plain version) and RANSAC of
rgbdslam_tpu_torch against rgbdslam_tpu on the same numpy inputs.

Counts are exact: the plain scorer computes each m^2 in the Pallas kernel's
operation order. Float sums are held to the JAX kernel test's rtol 1e-5.
Hypothesis sampling is injected (`draws`) so both packages fit the same
hypotheses; jax.random's bits cannot be reproduced in torch.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.config import RansacConfig as JRansacConfig
from rgbdslam_tpu.geometry import se3 as jse3
from rgbdslam_tpu.ops.pallas_kernels import mahal_hypothesis_scores as j_mahal
from rgbdslam_tpu.solvers import kabsch as jkabsch
from rgbdslam_tpu_torch.config import RansacConfig
from rgbdslam_tpu_torch.ops import kernels
from rgbdslam_tpu_torch.solvers import kabsch as tkabsch
from rgbdslam_tpu_torch.solvers import ransac_se3 as transac
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the JAX solvers package re-exports the function under the module's name
jransac = importlib.import_module("rgbdslam_tpu.solvers.ransac_se3")


def _problem(rng, H=64, N=256, outliers=0.0):
    xi = rng.normal(scale=0.1, size=(H, 6)).astype(np.float32)
    T_h = np.array(jse3.exp(jnp.asarray(xi)))
    p1 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    p1[:, 2] = rng.uniform(0.5, 4.0, N)
    T_true = np.asarray(jse3.exp(jnp.asarray(rng.normal(scale=0.05, size=6).astype(np.float32))))
    p2 = (p1 @ T_true[:3, :3].T + T_true[:3, 3]
          + rng.normal(scale=0.005, size=(N, 3))).astype(np.float32)
    bad = rng.uniform(size=N) < outliers
    p2[bad] += rng.normal(scale=0.5, size=(bad.sum(), 3)).astype(np.float32)
    valid = rng.uniform(size=N) > 0.2
    return T_h, p1, p2, valid, T_true


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_weighted_rigid_transform_matches():
    rng = np.random.default_rng(0)
    _, p1, p2, valid, T_true = _problem(rng, N=64)
    w = (1.0 / (p1[:, 2] * p2[:, 2]) * valid).astype(np.float32)
    idx = rng.integers(0, 64, size=(32, 4))
    a = np.asarray(jkabsch.weighted_rigid_transform(jnp.asarray(p1[idx]), jnp.asarray(p2[idx]),
                                                    jnp.asarray(w[idx])))
    b = tkabsch.weighted_rigid_transform(*_t(p1[idx], p2[idx], w[idx])).numpy()
    # 30 power iterations of 4x4 products: matmul summation order differs
    # between XLA and torch -> agreement to ~1e-5 on O(1) entries
    np.testing.assert_allclose(b, a, rtol=0, atol=3e-5)
    full = tkabsch.weighted_rigid_transform(*_t(p1, p2, w)).numpy()
    np.testing.assert_allclose(full, T_true, atol=5e-3)
    zero = tkabsch.weighted_rigid_transform(*_t(p1, p2, np.zeros_like(w))).numpy()
    np.testing.assert_array_equal(zero, np.eye(4, dtype=np.float32))


def test_sigma_and_mahalanobis_match_jax_scorer():
    rng = np.random.default_rng(1)
    cfg_j, cfg_t = JRansacConfig(), RansacConfig()
    T_h, p1, p2, valid, _ = _problem(rng)
    np.testing.assert_allclose(transac._sigma_diag(torch.from_numpy(p1[:, 2]), cfg_t).numpy(),
                               np.asarray(jransac._sigma_diag(jnp.asarray(p1[:, 2]), cfg_j)),
                               rtol=1e-6)
    inl_j, cnt_j, rmse_j = jransac._score(jnp.asarray(T_h), jnp.asarray(p1), jnp.asarray(p2),
                                          jnp.asarray(valid), cfg_j)
    inl_t, cnt_t, rmse_t = transac._score(*_t(T_h, p1, p2, valid), cfg_t)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    # the XLA scorer forms R p1 with an einsum (its own rounding); rtol 1e-5
    # as tests/test_pallas_ransac.py holds the kernel to it
    np.testing.assert_allclose(rmse_t.numpy(), np.asarray(rmse_j), rtol=1e-5)


@pytest.mark.parametrize("H,N,all_invalid", [(64, 256, False), (256, 1024, False),
                                             (32, 128, True)])
def test_mahal_ref_matches_pallas_kernel(H, N, all_invalid):
    rng = np.random.default_rng(H + N)
    cfg = JRansacConfig()
    T_h, p1, p2, valid, T_true = _problem(rng, H=H, N=N)
    T_h[0] = T_true                          # one hypothesis with many inliers
    if all_invalid:
        valid[:] = False
    s1 = np.asarray(jransac._sigma_diag(jnp.asarray(p1[:, 2]), cfg))
    s2 = np.asarray(jransac._sigma_diag(jnp.asarray(p2[:, 2]), cfg))
    cj, ej = j_mahal(*(jnp.asarray(a) for a in (T_h, p1, p2, s1, s2, valid)), 9.0,
                     interpret=True)
    ct, et = kernels.mahal_hypothesis_scores_ref(*_t(T_h, p1, p2, s1, s2, valid), 9.0)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    # the sum of m^2 is held as tests/test_pallas_ransac.py holds it: rtol
    # 1e-5 on rmse = sqrt(sum / count). Interpret mode sums the f32 terms in
    # sequence (error up to ~N eps, 3e-5 at N = 512), torch pairwise.
    cnt = np.maximum(ct.numpy(), 1)
    np.testing.assert_allclose(np.sqrt(et.numpy() / cnt), np.sqrt(np.asarray(ej) / cnt),
                               rtol=1e-5)
    if all_invalid:
        assert int(ct.sum()) == 0 and float(et.sum()) == 0.0
    else:
        assert int(ct.max()) > N // 2


def _jax_draws(key, valid, cfg):
    n_valid = max(int(valid.sum()), 1)
    return np.asarray(jax.random.randint(key, (cfg.num_hypotheses, cfg.sample_size), 0, n_valid))


@pytest.mark.parametrize("seed,outliers", [(0, 0.0), (1, 0.3), (2, 0.5)])
def test_ransac_with_injected_draws_matches_jax(seed, outliers):
    rng = np.random.default_rng(10 + seed)
    _, p1, p2, valid, T_true = _problem(rng, N=512, outliers=outliers)
    w = np.where(valid, 1.0 / (p1[:, 2] * p2[:, 2]), 0.0).astype(np.float32)
    cfg_j, cfg_t = JRansacConfig(), RansacConfig()
    key = jax.random.PRNGKey(seed)
    rj = jransac.ransac_se3(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w),
                            jnp.asarray(valid), key, cfg_j)
    draws = torch.from_numpy(_jax_draws(key, valid, cfg_j))
    rt = transac.ransac_se3(*_t(p1, p2, w, valid), None, cfg_t, draws=draws)
    assert bool(rt.success) == bool(rj.success) is True
    # same winner and refits -> identical inlier sets
    assert int(rt.num_inliers) == int(rj.num_inliers)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    # Horn fits through different matmul orderings: ~1e-5 on O(1) entries
    np.testing.assert_allclose(rt.T21.numpy(), np.asarray(rj.T21), rtol=0, atol=5e-5)
    np.testing.assert_allclose(float(rt.rmse), float(rj.rmse), rtol=1e-4)
    np.testing.assert_allclose(rt.T21.numpy(), T_true, atol=1e-2)


def test_ransac_generator_path_and_no_valid():
    rng = np.random.default_rng(3)
    _, p1, p2, valid, T_true = _problem(rng, N=256, outliers=0.2)
    w = np.where(valid, 1.0 / (p1[:, 2] * p2[:, 2]), 0.0).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    kernels.reset_launch_counts()
    r = transac.ransac_se3(*_t(p1, p2, w, valid), gen, RansacConfig())
    assert bool(r.success)
    assert kernels.LAUNCHES["mahal_hypothesis_scores"] == 0     # CPU: plain version
    np.testing.assert_allclose(r.T21.numpy(), T_true, atol=1e-2)
    none = transac.ransac_se3(*_t(p1, p2, w, np.zeros_like(valid)), gen, RansacConfig())
    assert not bool(none.success) and int(none.inliers.sum()) == 0
    with pytest.raises(ValueError):
        transac.ransac_se3(*_t(p1, p2, w, valid), None, RansacConfig())
