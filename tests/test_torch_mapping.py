"""Host stores (KeyframeStore, LandmarkStore, covisibility) and the packed
feature layouts of rgbdslam_tpu_torch against rgbdslam_tpu.

The stores are numpy code fed by the device's packed blobs: the same blob
through both packages must give equal arrays, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401
from rgbdslam_tpu.frontend import frame as jframe
from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.mapping import covisibility as jcovis
from rgbdslam_tpu.mapping.keyframes import KeyframeStore as JKeyframeStore
from rgbdslam_tpu.mapping.landmarks import LandmarkStore as JLandmarkStore
from rgbdslam_tpu_torch import convert
from rgbdslam_tpu_torch.frontend import frame as tframe
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.mapping import covisibility as tcovis
from rgbdslam_tpu_torch.mapping.keyframes import KeyframeStore
from rgbdslam_tpu_torch.mapping.landmarks import LandmarkStore
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM_ARGS = dict(fx=200.0, fy=200.0, cx=159.5, cy=119.5, width=320, height=240)
N = 96


def _features(rng, n=N):
    """A random but plausible feature table as numpy arrays."""
    uv = rng.uniform(10, 300, size=(n, 2)).astype(np.float32)
    z = rng.uniform(0.5, 5.0, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    has_depth = valid & (rng.uniform(size=n) > 0.1)
    z = np.where(has_depth, z, 0.0).astype(np.float32)
    xyz = np.stack([(uv[:, 0] - 159.5) / 200.0 * z, (uv[:, 1] - 119.5) / 200.0 * z, z], 1)
    return dict(
        uv=uv, uv_undist=uv.copy(), xyz=xyz.astype(np.float32),
        desc=rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32),
        score=rng.uniform(0, 100, n).astype(np.float32),
        level=rng.integers(0, 3, n).astype(np.int32), valid=valid, has_depth=has_depth,
        intensity=rng.uniform(-3.0, 260.0, n).astype(np.float32),
        smooth=has_depth & (rng.uniform(size=n) > 0.2),
        surf_cov=np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)))


def _both(d):
    fj = jframe.FrameFeatures(**{k: jnp.asarray(v) for k, v in d.items()})
    return fj, convert.frame_features_from_numpy(d, device="cpu")


def test_packed_feature_layouts_match():
    fj, ft = _both(_features(np.random.default_rng(0)))
    full_j = np.asarray(jframe.pack_features_for_host(fj))
    full_t = tframe.pack_features_for_host(ft).numpy()
    assert full_t.shape == (N, 16)
    # bit patterns, not values: descriptor words ride f32 lanes
    np.testing.assert_array_equal(full_t.view(np.uint32), full_j.view(np.uint32))
    slim_j = np.asarray(jframe.pack_features_slim(fj))
    slim_t = tframe.pack_features_slim(ft).numpy()
    np.testing.assert_array_equal(slim_t, slim_j)
    assert slim_t.shape == (N, 4) and slim_t[:, 3].max() <= 1023.0


@pytest.mark.parametrize("slim", [False, True])
def test_keyframe_store_matches(slim):
    rng = np.random.default_rng(1)
    sj, st = JKeyframeStore(2, N), KeyframeStore(2, N)          # both grow
    camj, camt = JCamera(**CAM_ARGS), Camera(**CAM_ARGS)
    for k in range(5):
        d = _features(rng)
        fj, ft = _both(d)
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, 3] = rng.normal(size=3)
        if slim:
            blob = tframe.pack_features_slim(ft).numpy()
            for s, cam in ((sj, camj), (st, camt)):
                assert s.register(0.1 * k, Tcw) == k
                s.fill_features_slim(k, blob, cam)
        elif k % 2:
            blob = tframe.pack_features_for_host(ft).numpy()
            assert sj.add_packed(0.1 * k, blob, 8, True, Tcw) == k
            assert st.add_packed(0.1 * k, blob, 8, True, Tcw) == k
        else:
            assert sj.add(0.1 * k, fj, Tcw) == st.add(0.1 * k, ft, Tcw) == k
    assert st.count == 5 and st.max_keyframes == sj.max_keyframes == 8
    for name in ("desc", "xyz", "obs_valid", "uv", "intensity", "smooth", "poses_cw",
                 "timestamps"):
        np.testing.assert_array_equal(getattr(st, name), getattr(sj, name), err_msg=name)
    np.testing.assert_array_equal(st.centers(), sj.centers())
    assert st.nearest(2, 2.0, 3) == sj.nearest(2, 2.0, 3)
    new = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    st.set_poses(new)
    assert np.array_equal(st.poses_cw[:3], new)
    for a, b in zip(st.features_of(1), sj.features_of(1)):
        np.testing.assert_array_equal(a, b)


def _drive_landmarks(store, rng, with_desc):
    """Six keyframes of tracks with full-track replacement (max_obs 3)."""
    centers = np.cumsum(rng.normal(scale=0.3, size=(6, 3)), axis=0).astype(np.float32)
    for k in range(6):
        d = _features(rng, 64)
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, 3] = -centers[k]
        match_idx = rng.permutation(64).astype(np.int32)
        match_idx[:6] = match_idx[6]                  # several previous kps -> one
        match_valid = rng.uniform(size=64) > 0.3
        store.add_keyframe(
            k, d["uv_undist"], d["xyz"], d["valid"] & d["has_depth"] & d["smooth"],
            d["desc"] if with_desc else None, d["intensity"], Tcw,
            match_idx if k else None, match_valid if k else None, k - 1 if k else None,
            kf_centers=centers[: k + 1] if k != 3 else None)
    return centers


@pytest.mark.parametrize("with_desc", [True, False])
def test_landmark_store_matches(with_desc):
    lj, lt = JLandmarkStore(32, 3, 64), LandmarkStore(32, 3, 64)      # both grow
    _drive_landmarks(lj, np.random.default_rng(2), with_desc)
    _drive_landmarks(lt, np.random.default_rng(2), with_desc)
    assert lt.count == lj.count > 64 and lt.L == lj.L > 32
    assert (lt.obs_replaced, lt.obs_dropped) == (lj.obs_replaced, lj.obs_dropped)
    assert lt.obs_replaced > 0 and lt.obs_dropped > 0
    for name in ("Xw", "valid", "desc", "intensity", "obs_kf", "obs_uv", "obs_z",
                 "obs_valid", "obs_count"):
        np.testing.assert_array_equal(getattr(lt, name), getattr(lj, name), err_msg=name)
    for k in range(6):
        np.testing.assert_array_equal(lt.kp2lm[k], lj.kp2lm[k])
    rng = np.random.default_rng(3)
    old = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    new = old.copy()
    new[:, :3, 3] = rng.normal(scale=0.1, size=(6, 3))
    lj.reanchor(old, new)
    lt.reanchor(old, new)
    np.testing.assert_array_equal(lt.Xw, lj.Xw)
    for a, b in zip(lt.world_points(), lj.world_points()):
        np.testing.assert_array_equal(a, b)
    ids = np.arange(5)
    X = rng.normal(size=(8, 3)).astype(np.float32)
    lj.update_from_solution(ids, X)
    lt.update_from_solution(ids, X)
    np.testing.assert_array_equal(lt.Xw, lj.Xw)
    # the bundle-adjustment window (tests/test_torch_ba.py solves it)
    for args in ((0, 3, old), (2, 5, new)):
        pj, lm_j, kf_j = lj.window_problem(*args)
        pt, lm_t, kf_t = lt.window_problem(*args, device="cpu")
        np.testing.assert_array_equal(lm_t, lm_j)
        np.testing.assert_array_equal(kf_t, kf_j)
        for name in pj._fields:
            np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                          err_msg=name)

    cj, ct = jcovis.covisibility_matrix(lj, 6), tcovis.covisibility_matrix(lt, 6)
    np.testing.assert_array_equal(ct, cj)
    assert ct.max() > 0
    for k in range(6):
        assert tcovis.connections(ct, k, 5) == jcovis.connections(cj, k, 5)
        assert tcovis.best_covisibles(ct, k, 3) == jcovis.best_covisibles(cj, k, 3)
    assert tcovis.spanning_tree(ct) == jcovis.spanning_tree(cj)
