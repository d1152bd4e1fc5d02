"""Serial full SLAM of the SIFT family of rgbdslam_tpu_torch against
rgbdslam_tpu (128-D float descriptors, L2 matching, a float codebook
trained online) over the tour's first 12 frames at 320x240 with 512
features; the last frame's features of both runs; and a map.npz with float
descriptors across the packages, both ways. The ORB family runs the same
tests in tests/test_torch_families_slam_orb.py (its JAX run alone takes
most of a file's time budget).

Both systems see the same pixels; their RANSAC draws differ, so the runs
are held by accuracy and counts with tests/test_torch_system.py's bounds.
"""

import types

import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.config import ExtractorConfig as JExtractorConfig
from rgbdslam_tpu.config import LoopConfig as JLoopConfig
from rgbdslam_tpu.config import SlamConfig as JSlamConfig
from rgbdslam_tpu.eval.ate import ate_rmse as j_ate
from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.io.synthetic import SyntheticDataset as JSyntheticDataset
from rgbdslam_tpu.loop.vocabulary import shipped_vocabulary as j_shipped
from rgbdslam_tpu.slam import system as jsystem
from rgbdslam_tpu.utils import serialization as jser
from rgbdslam_tpu_torch import convert
from rgbdslam_tpu_torch.eval.ate import ate_rmse
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
from rgbdslam_tpu_torch.slam.system import SlamSystem
from rgbdslam_tpu_torch.utils import serialization as tser
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM_ARGS = dict(fx=200.0, fy=200.0, cx=159.5, cy=119.5, width=320, height=240)
EX = dict(num_features=512, cell_size=8, fast_threshold=15.0)
N_FRAMES = 12
FAMILIES = ["sift"]


def _jcfg(detector):
    return JSlamConfig(extractor=JExtractorConfig(**EX), detector=detector,
                       loop=JLoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=256))


@pytest.fixture(scope="module")
def frames():
    """The tour's first 12 frames (loops=1.15) rendered once by the JAX
    package, as numpy."""
    ds = JSyntheticDataset(n_frames=128, cam=JCamera(**CAM_ARGS), trajectory="tour",
                           loops=1.15)
    return ds, [(float(t), np.array(g), np.array(d))
                for t, g, d in (ds.grab(i) for i in range(N_FRAMES))]


_RUNS = {}


def _family_run(detector, frames):
    """Both packages' serial runs of one family (the shipped vocabulary
    where the family has one, else online training), made once."""
    if detector not in _RUNS:
        _, fr = frames
        st = SlamSystem(Camera(**CAM_ARGS), convert.config_from_jax(_jcfg(detector)), seed=0,
                        device="cpu")
        sj = jsystem.SlamSystem(JCamera(**CAM_ARGS), _jcfg(detector), seed=0)
        if shipped_vocabulary(detector):
            st.load_vocabulary(shipped_vocabulary(detector))
            sj.load_vocabulary(j_shipped(detector))
        for system in (st, sj):
            for ts, g, d in fr:
                system.track(ts, g, d)
            system.finish()
        _RUNS[detector] = (detector, st, sj)
    return _RUNS[detector]


@pytest.fixture(scope="module", params=FAMILIES)
def runs(request, frames):
    return _family_run(request.param, frames)


def test_family_slam_matches_jax(frames, runs):
    """ATE of both < 0.06 m and within 0.02 m of each other, keyframe counts
    within 10 %, the descriptor bank of the family's shape and type."""
    ds, _ = frames
    detector, st, sj = runs
    ts_t, poses_t = st.camera_trajectory()
    ts_j, poses_j = sj.camera_trajectory()
    rt, info = ate_rmse(ts_t, poses_t, ds.timestamps[:N_FRAMES], ds.poses_twc[:N_FRAMES])
    rj, _ = j_ate(ts_j, poses_j, ds.timestamps[:N_FRAMES], ds.poses_twc[:N_FRAMES])
    assert info["pairs"] == N_FRAMES and np.isfinite(poses_t).all()
    assert rt < 0.06 and rj < 0.06, (rt, rj)
    assert abs(rt - rj) < 0.02, (rt, rj)
    assert abs(st.store.count - sj.store.count) <= 0.1 * sj.store.count
    assert st.tracker.stats.failures == 0
    bank = st._bank[0]
    if detector == "sift":
        assert bank.dtype == torch.float32 and bank.shape[1:] == (512, 128)
        assert st.loop_detector.words.dtype == torch.float32     # trained online
    else:
        assert bank.dtype == torch.int32 and bank.shape[1:] == (512, 8)


def test_family_last_frame_features_match_jax(runs):
    """The last frame's features as each tracker built them: keypoints in at
    least 99 % of the slots (all for sift; orb's x1.2 levels differ by ulps,
    tests/test_torch_families_build.py), binary bits >= 99.9 % and float
    rows within 1e-5 outside counted bin flips on equal keypoints."""
    detector, st, sj = runs
    ft, fj = st.tracker.ref_frame, sj.tracker.ref_frame
    same = (ft.uv.numpy() == np.asarray(fj.uv)).all(axis=1)
    assert same.mean() >= (1.0 if detector == "sift" else 0.99), same.mean()
    dt, dj = ft.desc.numpy()[same], np.asarray(fj.desc)[same]
    if detector == "sift":
        assert (np.abs(dt - dj).max(axis=1) > 1e-5).mean() <= 0.01
    else:
        x = np.unpackbits((dt.view(np.uint32) ^ dj).view(np.uint8))
        assert x.mean() <= 0.001


def test_float_map_npz_both_ways(tmp_path, frames):
    """The sift run's map.npz ((K, N, 128) f32 descriptors, a float
    vocabulary) loads in the JAX package with equal arrays, and the file the
    JAX package writes from it loads back into the port, the device bank
    rebuilt as f32 rows. The JAX store is shaped for the float family first:
    it takes its descriptor shape from the first keyframe it fills."""
    _, st, _ = _family_run("sift", frames)
    pt, pj = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tser.save_map(pt, st)
    sj = jsystem.SlamSystem(JCamera(**CAM_ARGS), _jcfg("sift"), seed=0)
    sj.store.desc = np.zeros((sj.store.max_keyframes, 512, 128), np.float32)
    jser.load_map(pt, sj)
    K = st.store.count
    np.testing.assert_array_equal(sj.store.desc[:K], st.store.desc[:K])
    np.testing.assert_array_equal(np.asarray(sj.loop_detector.words),
                                  st.loop_detector.words.numpy())
    jser.save_map(pj, sj)
    with np.load(pt) as a, np.load(pj) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    s2 = SlamSystem(Camera(**CAM_ARGS), convert.config_from_jax(_jcfg("sift")), device="cpu")
    tser.load_map(pj, s2)
    assert s2.store.desc.dtype == np.float32
    np.testing.assert_array_equal(s2.store.desc[:K], st.store.desc[:K])
    assert s2._bank[0].dtype == torch.float32
    np.testing.assert_array_equal(s2._bank[0][:K].numpy(), st.store.desc[:K])
    np.testing.assert_array_equal(s2.loop_detector.words.numpy(),
                                  st.loop_detector.words.numpy())
    f0 = types.SimpleNamespace(desc=s2._bank[0][0], xyz=s2._bank[1][0],
                               obs_valid=s2._bank[2][0])
    _T, _ninl, ok, nm = s2._verify_candidates([0], f0)
    assert bool(ok[0]) and int(nm[0]) > 50, int(nm[0])
