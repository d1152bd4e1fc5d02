"""Whole runs of the serial full-SLAM path of rgbdslam_tpu_torch against
rgbdslam_tpu: both packages over the same 100 frames, relocalization after a
blackout, online vocabulary training and bank growth, the bare tracker.

Both systems see the same pixels (frames rendered once by the JAX package);
their RANSAC draws differ (jax.random against torch.Generator), so whole
runs are held by accuracy and counts, not by bits. The per-keyframe device
work is held exactly in tests/test_torch_kfcore.py.
"""


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
from rgbdslam_tpu_torch import convert
from rgbdslam_tpu_torch.eval.ate import ate_rmse
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
from rgbdslam_tpu_torch.ops import kernels
from rgbdslam_tpu_torch.slam.system import SlamSystem
from rgbdslam_tpu_torch.slam.tracking import Tracker, TrackerState
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM_ARGS = dict(fx=200.0, fy=200.0, cx=159.5, cy=119.5, width=320, height=240)
EX = dict(num_features=1024, num_levels=3, cell_size=8, fast_threshold=15.0)
# tests/test_system.py's camera and configuration (short sequence: shrunk
# loop gates); the shipped vocabulary is loaded, so vocab_size is unused
JCFG = JSlamConfig(extractor=JExtractorConfig(**EX),
                   loop=JLoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=256))
TCFG = convert.config_from_jax(JCFG)
N_FRAMES = 100


@pytest.fixture(scope="module")
def frames():
    """The 100-frame orbit (loops=1.15) rendered once by the JAX package, as
    numpy: both systems see the same pixels."""
    ds = JSyntheticDataset(n_frames=N_FRAMES, cam=JCamera(**CAM_ARGS), trajectory="orbit",
                           loops=1.15)
    out = []
    for i in range(N_FRAMES):
        ts, g, d = ds.grab(i)
        out.append((float(ts), np.asarray(g), np.asarray(d)))
    return ds, out


def _run_port(frames, n=N_FRAMES, blank=(), cfg=TCFG, vocabulary=True, seed=0):
    system = SlamSystem(Camera(**CAM_ARGS), cfg, seed=seed, device="cpu")
    if vocabulary:
        system.load_vocabulary(shipped_vocabulary("svo_fast"))
    for i, (ts, g, d) in enumerate(frames[:n]):
        if i in blank:
            g, d = np.zeros_like(g), np.zeros_like(d)       # occluded sensor
        system.track(ts, g, d)
    system.finish()
    return system


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_run(frames):
    kernels.reset_launch_counts()
    system = _run_port(frames[1])
    return system, dict(kernels.LAUNCHES)


@pytest.fixture(scope="module")
def jax_run(frames):
    system = jsystem.SlamSystem(JCamera(**CAM_ARGS), JCFG, seed=0)
    system.load_vocabulary(j_shipped("svo_fast"))
    for ts, g, d in frames[1]:
        system.track(ts, g, d)
    system.finish()
    return system


def test_full_run_matches_jax_package(frames, port_run, jax_run):
    """Both packages over the same 100 frames (their RANSAC draws differ:
    jax.random against torch.Generator): both accurate, close to each
    other, both close the loop, keyframe counts within 10 %."""
    ds = frames[0]
    st, sj = port_run[0], jax_run
    ts_t, poses_t = st.camera_trajectory()
    ts_j, poses_j = sj.camera_trajectory()
    rt, info = ate_rmse(ts_t, poses_t, ds.timestamps, ds.poses_twc)
    rj, _ = j_ate(ts_j, poses_j, ds.timestamps, ds.poses_twc)
    assert info["pairs"] == N_FRAMES and np.isfinite(poses_t).all()
    assert rt < 0.06 and rj < 0.06, (rt, rj)
    assert abs(rt - rj) < 0.02, (rt, rj)
    assert st.loops_closed >= 1 and sj.loops_closed >= 1
    assert abs(st.store.count - sj.store.count) <= 0.1 * sj.store.count
    assert st.tracker.stats.failures <= 3 and st.tracker.state is TrackerState.OK
    assert len(st.loop_solve_ms) == st.loops_closed
    assert len(st.kf_backend_ms) == st.store.count


def test_system_builds_graph_and_stores(port_run):
    system, launches = port_run
    K = system.store.count
    assert K >= 10 and system.graph.n_vertices == K == system.loop_detector.count
    assert system.graph.n_edges > K - 1                    # proximity and/or loop edges
    assert len(system.tracker.keyframes) == K
    assert system.landmarks.count > 1000 and system.landmarks.obs_count.max() >= 3
    ts_k, poses_k = system.keyframe_trajectory()
    assert poses_k.shape == (K, 4, 4)
    np.testing.assert_allclose(poses_k, np.linalg.inv(system.store.poses_cw[:K]), atol=1e-4)
    # on the CPU every wrapper took its plain version
    assert all(v == 0 for v in launches.values()), launches


def test_hydrate_and_rebuild_bank(port_run):
    """Slim blobs ship no descriptors: hydrate_host fills the host mirrors
    from the device bank, and a bank rebuilt from the host equals it."""
    system, _ = port_run
    K = system.store.count
    assert len(system._lazy_rows) == K and not system.store.desc[:K].any()
    system.hydrate_host()
    assert not system._lazy_rows and system.store.desc[:K].any()
    f0 = system.tracker.keyframes[0][1]
    np.testing.assert_array_equal(system.store.desc[0], f0.desc.numpy().view(np.uint32))
    assert abs(float(system.loop_detector.bow_db[3].sum()) - 1.0) < 1e-4
    old = [b.clone() for b in system._bank]
    system.rebuild_bank_from_store()
    for a, b, name in zip(system._bank, old, "DXVB"):
        if name == "X":     # the host rebuilds xyz from (uv, z): equal to rounding
            torch.testing.assert_close(a[:K], b[:K], rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(a[:K], b[:K]), name


def test_system_relocalizes_after_blackout(frames):
    """Five blanked frames: the tracker enters LOST after `lost_after`
    failures and relocalizes against the BoW keyframe database once the
    scene returns; the tail of the run matches ground truth again."""
    ds, fr = frames
    n = 64
    system = _run_port(fr, n=n, blank=range(30, 35))
    assert system.tracker.stats.failures >= 5
    assert system.tracker.stats.relocalizations >= 1
    assert system.tracker.state is TrackerState.OK
    ts_e, poses = system.camera_trajectory()
    tail = slice(40, None)
    rmse_tail, info = ate_rmse(ts_e[tail], poses[tail], ds.timestamps[40:n],
                               ds.poses_twc[40:n])
    assert info["pairs"] >= 20 and rmse_tail < 0.10, rmse_tail


def test_online_vocabulary_and_bank_growth(frames):
    """Without a loaded vocabulary the codebook trains on the first five
    keyframes and the run switches to slim blobs; a two-keyframe bank and
    store double as the map grows."""
    import dataclasses

    _, fr = frames
    cfg = dataclasses.replace(
        TCFG, loop=dataclasses.replace(TCFG.loop, vocab_size=64, vocab_iters=2),
        keyframe=dataclasses.replace(TCFG.keyframe, max_keyframes=2))
    system = _run_port(fr, n=24, cfg=cfg, vocabulary=False)
    K = system.store.count
    assert K >= 8 and system.loop_detector.words.shape == (64, 8)
    assert system._bank[0].shape[0] >= K and system._bank[3].shape[1] == 64
    assert system.store.desc[:5].any() and system.store.max_keyframes >= K
    assert sorted(system._lazy_rows) == list(range(5, K))
    assert system.graph.n_vertices == K and system.tracker.stats.failures == 0
    # rows quantized on the host at training time and on the device later
    assert float(system._bank[3][:K].sum(dim=1).min()) > 0.99


def test_tracker_alone_and_adaptive_threshold(frames):
    _, fr = frames
    import dataclasses

    tr = Tracker(Camera(**CAM_ARGS), TCFG, seed=1, device="cpu")
    for ts, g, d in fr[:6]:
        Tcw = tr.track(ts, g, d)
    assert Tcw.shape == (4, 4) and tr.stats.frames == 5 and tr.stats.failures == 0
    assert len(tr.trajectory) == 6 and len(tr.keyframes) >= 2
    # a threshold no corner passes: ADAPTIVE lowers it within the frame
    cfg = dataclasses.replace(
        TCFG, adaptive=True,
        extractor=dataclasses.replace(TCFG.extractor, fast_threshold=120.0))
    ta = Tracker(Camera(**CAM_ARGS), cfg, device="cpu")
    for ts, g, d in fr[:3]:
        ta.track(ts, g, d)
    assert ta._extractor.threshold < 120.0 * 0.7 + 1e-6
    assert int(ta.ref_frame.valid.sum()) > 0


