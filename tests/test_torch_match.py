"""Matching (K2's plain version, match_frames) of rgbdslam_tpu_torch against
rgbdslam_tpu. Every output here is an integer or a mask: all exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbdslam_tpu.frontend import matcher as jmatch
from rgbdslam_tpu.ops import hamming as jham
from rgbdslam_tpu.ops.pallas_kernels import hamming_match_2nn as j_match_kernel
from rgbdslam_tpu_torch.ops import hamming as tham
from rgbdslam_tpu_torch.ops import kernels
from rgbdslam_tpu_torch.frontend import matcher as tmatch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _descs(rng, n, m, p_valid=0.9):
    d1 = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, size=(m, 8), dtype=np.uint32)
    # make some rows near-duplicates so distances are small and tie
    k = min(n, m) // 2
    d2[:k] = d1[:k] ^ (rng.integers(0, 2**32, size=(k, 8), dtype=np.uint32)
                       & rng.integers(0, 2**32, size=(k, 8), dtype=np.uint32)
                       & rng.integers(0, 2**32, size=(k, 8), dtype=np.uint32))
    d2[k:k + 4] = d2[:4]                    # exact duplicate trains -> index ties
    v1 = rng.random(n) < p_valid
    v2 = rng.random(m) < p_valid
    return d1, d2, v1, v2


def _t(d):
    return torch.from_numpy(np.ascontiguousarray(d).view(np.int32))


def test_popcount_and_distance_matrix_match():
    rng = np.random.default_rng(0)
    d1, d2, v1, v2 = _descs(rng, 96, 80)
    d1[0] = 0xFFFFFFFF
    np.testing.assert_array_equal(tham.popcount_rows(_t(d1)).numpy(),
                                  np.asarray(jham.popcount_rows(jnp.asarray(d1))))
    a = np.asarray(jham.hamming_distance_matrix(jnp.asarray(d1), jnp.asarray(d2),
                                                jnp.asarray(v1), jnp.asarray(v2)))
    b = tham.hamming_distance_matrix(_t(d1), _t(d2), torch.from_numpy(v1),
                                     torch.from_numpy(v2)).numpy()
    np.testing.assert_array_equal(b, a)
    for x, y in zip(jham.knn2(jnp.asarray(a)), tham.knn2(torch.from_numpy(b))):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


@pytest.mark.parametrize("n,m,p_valid", [(512, 512, 0.9), (1000, 1000, 0.8),
                                         (300, 257, 0.5), (64, 64, 0.0)])
def test_hamming_ref_matches_pallas_kernel(n, m, p_valid):
    """All four outputs equal the Pallas kernel's (interpret mode), including
    invalid slots, rows with no valid pair, and N not a tile multiple."""
    rng = np.random.default_rng(n + m)
    d1, d2, v1, v2 = _descs(rng, n, m, p_valid)
    j = j_match_kernel(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
                       jnp.asarray(v2), 256, True)
    t = kernels.hamming_match_2nn_ref(_t(d1), _t(d2), torch.from_numpy(v1),
                                      torch.from_numpy(v2))
    for name, a, b in zip(("best_idx", "best_dist", "second", "col_best"), j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_match_descriptors_matches_jax():
    rng = np.random.default_rng(3)
    d1, d2, v1, v2 = _descs(rng, 700, 650)
    j = jmatch.match_descriptors(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2),
                                 jnp.asarray(v2), 0.9)
    t = tmatch.match_descriptors(_t(d1), torch.from_numpy(v1), _t(d2),
                                 torch.from_numpy(v2), 0.9)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.idx2.numpy(), np.asarray(j.idx2))
    np.testing.assert_array_equal(t.dist.numpy(), np.asarray(j.dist))
    assert int(t.num_matches) > 100


def test_match_frames_and_gather_match_jax():
    """match_frames + gather_matched_points on JAX-built features of two
    rendered frames, handed to the port through convert.py."""
    from rgbdslam_tpu.config import ExtractorConfig
    from rgbdslam_tpu.frontend.frame import build_frame_features
    from rgbdslam_tpu.geometry.camera import Camera
    from rgbdslam_tpu.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.convert import frame_features_from_numpy

    cam = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
    ex = ExtractorConfig(num_features=1024, num_levels=3, cell_size=8, fast_threshold=15.0)
    ds = SyntheticDataset(n_frames=24, cam=cam, trajectory="sweep")
    fj = [build_frame_features(cam, *ds.grab(i)[1:], ex) for i in (4, 5)]
    ft = [frame_features_from_numpy({k: np.asarray(getattr(f, k))
                                     for k in f.__dataclass_fields__}, device="cpu") for f in fj]
    mj = jmatch.match_frames(fj[0], fj[1], 0.9)
    mt = tmatch.match_frames(ft[0], ft[1], 0.9)
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    np.testing.assert_array_equal(mt.idx2.numpy(), np.asarray(mj.idx2))
    assert int(mt.num_matches) > 100
    gj = jmatch.gather_matched_points(fj[0], fj[1], mj)
    gt = tmatch.gather_matched_points(ft[0], ft[1], mt)
    for a, b in zip(gj, gt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_match_descriptors_cpu_never_launches():
    rng = np.random.default_rng(4)
    d1, d2, v1, v2 = _descs(rng, 64, 64)
    kernels.reset_launch_counts()
    tmatch.match_descriptors(_t(d1), torch.from_numpy(v1), _t(d2), torch.from_numpy(v2))
    assert kernels.LAUNCHES["hamming_match_2nn"] == 0
    with pytest.raises(ValueError):
        kernels.hamming_match_2nn(_t(d1), _t(d2), torch.from_numpy(v1), torch.from_numpy(v2))
