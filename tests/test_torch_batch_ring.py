"""Batched (`track_batch*`) and ring (`track_pipelined*`) full SLAM of
rgbdslam_tpu_torch against its serial mode and against rgbdslam_tpu's
batched mode, on the same frames (a 48-frame orbit at 320x240, rendered once
by the JAX package).

Within the port the RANSAC draws come from one torch.Generator in the same
order in every mode, so without a second-reference retry the ring and the
double-buffered batches reproduce their references to rounding. Against the
JAX package the draws differ (jax.random against torch.Generator): whole
runs are held by accuracy and counts. The device keyframe gate and ADAPTIVE
update are held exactly on the JAX scan's own rows.
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
from rgbdslam_tpu.slam import tracking as jtracking
from rgbdslam_tpu_torch import convert
from rgbdslam_tpu_torch.eval.ate import ate_rmse
from rgbdslam_tpu_torch.frontend.extractor import Extractor
from rgbdslam_tpu_torch.frontend.frame import build_frame_features
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
from rgbdslam_tpu_torch.ops import fast, image, kernels
from rgbdslam_tpu_torch.slam.system import SlamSystem
from rgbdslam_tpu_torch.slam.tracking import Tracker, TrackerState, keyframe_gate
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM_ARGS = dict(fx=200.0, fy=200.0, cx=159.5, cy=119.5, width=320, height=240)
# tests/test_torch_system.py's configuration (the loop gates shrunk for a
# short sequence); 1,024 features track every frame of this orbit
EX = dict(num_features=1024, num_levels=3, cell_size=8, fast_threshold=15.0)
JCFG = JSlamConfig(extractor=JExtractorConfig(**EX),
                   loop=JLoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=256))
TCFG = convert.config_from_jax(JCFG)
# tests/test_extractor_cli.py::test_adaptive_feedback_in_batched_scan's
# configuration: a threshold too high for the band, which the device lowers
JACFG = JSlamConfig(extractor=JExtractorConfig(num_features=128, num_levels=2, cell_size=8,
                                               fast_threshold=60.0, adapt_target_min=60,
                                               adapt_target_max=120),
                    adaptive=True)
N_FRAMES, B = 48, 8


@pytest.fixture(scope="module")
def frames():
    """The 48-frame orbit rendered once by the JAX package, as numpy."""
    ds = JSyntheticDataset(n_frames=N_FRAMES, cam=JCamera(**CAM_ARGS), trajectory="orbit")
    out = []
    for i in range(N_FRAMES):
        ts, g, d = ds.grab(i)
        out.append((float(ts), np.asarray(g), np.asarray(d)))
    return ds, out


def _system(cfg=TCFG):
    system = SlamSystem(Camera(**CAM_ARGS), cfg, seed=0, device="cpu")
    system.load_vocabulary(shipped_vocabulary("svo_fast"))
    return system


def _batches(fr, b=B):
    return [tuple(zip(*fr[i:i + b])) for i in range(0, len(fr), b)]


def _ate(system, ds):
    ts, poses = system.camera_trajectory()
    rmse, info = ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)
    assert info["pairs"] == len(ts) and np.isfinite(poses).all()
    return rmse, poses


@pytest.fixture(scope="module")
def serial_run(frames):
    system = _system()
    for ts, g, d in frames[1]:
        system.track(ts, g, d)
    system.finish()
    return system


@pytest.fixture(scope="module")
def batch_run(frames):
    kernels.reset_launch_counts()
    system = _system()
    for batch in _batches(frames[1]):
        out = system.track_batch(*batch)
        assert out.shape == (len(batch[0]), 4, 4)
    system.finish()
    assert all(v == 0 for v in kernels.LAUNCHES.values())     # CPU: plain versions
    return system


@pytest.fixture(scope="module")
def ring_run(frames):
    system = _system()
    done = []
    for ts, g, d in frames[1]:
        out = system.track_pipelined(ts, g, d)
        if out is not None:
            done.append(out[0])
    done.append(system.track_pipelined_flush()[0])
    system.finish()
    assert done == [ts for ts, _, _ in frames[1]]       # each frame completed once, in order
    return system


def test_batch_matches_serial(frames, serial_run, batch_run):
    """test_batched_tracking_matches_per_frame's bounds (tests/test_system.py):
    keyframe counts within 20 % + 1, both ATEs < 0.12 m, the batch's below
    max(1.5 x serial's, 0.05 m)."""
    ds = frames[0]
    s1, s2 = serial_run, batch_run
    r1, _ = _ate(s1, ds)
    r2, _ = _ate(s2, ds)
    assert len(s2.tracker.trajectory) == N_FRAMES
    assert abs(s2.store.count - s1.store.count) <= 0.2 * s1.store.count + 1
    assert r1 < 0.12 and r2 < 0.12, (r1, r2)
    assert r2 < max(1.5 * r1, 0.05), (r2, r1)
    # one estimate per frame after the first: batched mode never retries
    assert s2.tracker.stats.estimates == s2.tracker.stats.frames == N_FRAMES - 1
    # the backend ran once per keyframe, dispatch and completion timed together
    assert len(s2.kf_backend_ms) == s2.store.count == s2.graph.n_vertices
    assert len(s2.tracker.keyframes) == s2.store.count
    assert s2.tracker.state is TrackerState.OK and s2.tracker._batch_carry is not None


def test_double_buffered_batches_match_sequential(frames, batch_run):
    """Batch i+1 dispatched before batch i is completed: the carry chains on
    the device and the draws come in the same order, so the trajectory is
    the sequential one's (atol 1e-5, the JAX test's bound)."""
    ds, fr = frames
    system = _system()
    pending = None
    for batch in _batches(fr):
        h = system.track_batch_dispatch(*batch)
        if pending is not None:
            system.track_batch_complete(pending)
        pending = h
    system.track_batch_complete(pending)
    system.finish()
    _, p1 = _ate(batch_run, ds)
    _, p2 = _ate(system, ds)
    assert system.store.count == batch_run.store.count
    assert system.loops_closed == batch_run.loops_closed
    np.testing.assert_allclose(p2, p1, atol=1e-5)


def test_ring_matches_serial(frames, serial_run, ring_run):
    """test_pipelined_ring_matches_per_frame's bounds (tests/test_system.py):
    the same keyframes, loops and failures, positions within 0.02 m (the
    backend completes one frame late)."""
    ds = frames[0]
    s1, s2 = serial_run, ring_run
    r1, p1 = _ate(s1, ds)
    r2, p2 = _ate(s2, ds)
    assert len(p2) == N_FRAMES
    assert s2.store.count == s1.store.count
    assert s2.loops_closed == s1.loops_closed
    assert s2.tracker.stats.failures == s1.tracker.stats.failures
    assert s2.tracker.stats.estimates == s1.tracker.stats.estimates
    assert ([fr.num_inliers for fr in s2.tracker.trajectory]
            == [fr.num_inliers for fr in s1.tracker.trajectory])
    assert r1 < 0.06 and r2 < 0.06, (r1, r2)
    diff = np.linalg.norm(p2[:, :3, 3] - p1[:, :3, 3], axis=-1)
    assert float(diff.max()) < 0.02, diff.max()
    assert len(s2.kf_backend_ms) == s2.store.count


def test_batch_matches_jax_package(frames, batch_run):
    """rgbdslam_tpu's track_batch on the same frames, with the same B and
    vocabulary: both accurate (< 0.12 m), keyframe counts within 20 % + 1."""
    ds, fr = frames
    js = jsystem.SlamSystem(JCamera(**CAM_ARGS), JCFG, seed=0)
    js.load_vocabulary(j_shipped("svo_fast"))
    for batch in _batches(fr):
        js.track_batch(*batch)
    js.finish()
    ts_j, poses_j = js.camera_trajectory()
    rj, _ = j_ate(ts_j, poses_j, ds.timestamps, ds.poses_twc)
    rt, _ = _ate(batch_run, ds)
    assert rt < 0.12 and rj < 0.12, (rt, rj)
    assert abs(batch_run.store.count - js.store.count) <= 0.2 * js.store.count + 1


def test_gate_and_adaptive_update_on_jax_rows(frames):
    """The JAX scan's own (B, 22) rows (ADAPTIVE on, 16 frames) fed into the
    port's keyframe gate and ADAPTIVE update, chained from the JAX scan's
    start: the kf flags and the thresholds equal the JAX rows exactly."""
    _, fr = frames
    jt = jtracking.Tracker(JCamera(**CAM_ARGS), JACFG, seed=0)
    h = jt.track_batch_dispatch(*zip(*fr[:16]))
    rows = np.asarray(h["packed"])
    thr0 = jt._thr_val                   # the scan's start, after the first frame
    jt.track_batch_complete(h)
    assert rows.shape == (15, 22)

    cfg = convert.config_from_jax(JACFG)
    ex = Extractor(Camera(**CAM_ARGS), cfg.extractor, detector=cfg.detector, adaptive=True)
    D = torch.eye(4)
    thr = torch.tensor(thr0, dtype=torch.float32)
    kf_flags, thrs = [], []
    for row in rows:
        kf, D = keyframe_gate(torch.from_numpy(row[:16].reshape(4, 4).copy()),
                              torch.tensor(bool(row[16] > 0.5)), D, cfg.keyframe)
        thr = ex.adapt_on_device(thr, torch.tensor(row[20]))
        kf_flags.append(float(kf))
        thrs.append(thr.item())
    np.testing.assert_array_equal(np.float32(kf_flags), rows[:, 19])
    np.testing.assert_array_equal(np.float32(thrs), rows[:, 21])
    # the rows exercise the gate both ways and the band both ways
    assert 0 < rows[:, 19].sum() < len(rows)
    assert (rows[:, 20] < 60).any() and (rows[:, 20] > 120).any()


def test_adaptive_feedback_in_batched_scan(frames):
    """tests/test_extractor_cli.py::test_adaptive_feedback_in_batched_scan on
    the port: a batch of 9 frames started at threshold 60 converges toward
    the band on the device; the host extractor syncs to the evolved
    threshold at completion and respects the clamp."""
    _, fr = frames
    cfg = convert.config_from_jax(JACFG)
    tr = Tracker(Camera(**CAM_ARGS), cfg, seed=0, device="cpu")
    out = tr.track_batch(*zip(*fr[:9]))
    assert out.shape == (9, 4, 4) and len(tr.trajectory) == 9
    assert tr._extractor.threshold < 60.0 * 0.7 + 1e-6, tr._extractor.threshold
    assert tr._extractor.threshold >= tr._extractor.th_min - 1e-6
    # the carry holds the same threshold on the device
    assert tr._batch_carry[3].item() == np.float32(tr._extractor.threshold)


def test_mid_batch_blackout_relocalizes(frames):
    """tests/test_reloc_batch.py::test_mid_batch_failure_burst_relocalizes,
    shortened: a 4-frame blackout across a batch boundary (frames 22-25)
    drives the batched system into LOST; BoW relocalization brings it back,
    and the surviving frames stay accurate."""
    import dataclasses

    ds, fr = frames
    n, lo, hi = 40, 22, 26
    rng = np.random.default_rng(7)
    seq = []
    for i, (ts, g, d) in enumerate(fr[:n]):
        if lo <= i < hi:      # featureless noise and no depth: the sensor drops out
            g = rng.normal(0.5, 0.003, g.shape).astype(np.float32)
            d = np.zeros_like(d)
        seq.append((ts, g, d))
    system = _system(dataclasses.replace(TCFG, lost_after=2))
    for batch in _batches(seq):
        system.track_batch(*batch)
    system.finish()
    st = system.tracker.stats
    assert st.failures >= hi - lo - 1 and st.relocalizations >= 1, (st.failures,
                                                                     st.relocalizations)
    assert system.tracker.state is TrackerState.OK
    ts, poses = system.camera_trajectory()
    keep = np.array([i < lo or i >= hi for i in range(n)])
    rmse, _ = ate_rmse(np.asarray(ts)[keep], poses[keep], ds.timestamps, ds.poses_twc)
    assert rmse < 0.08, rmse


def test_modes_switch_and_single_frame_batches(frames):
    """A run that starts with one-frame batches (the first only initialises),
    switches to the ring, then to serial tracking, then back to batches: every
    switch drains or re-seeds what the previous mode left, each frame is
    tracked once, and the trajectory stays on the ground truth."""
    ds, fr = frames
    system = _system()
    t = system.tracker
    assert system.track_batch(*zip(*fr[:1])).shape == (1, 4, 4)
    assert len(t.trajectory) == 1 and system.store.count == 1
    system.track_batch(*zip(*fr[1:2]))
    for ts, g, d in fr[2:10]:
        system.track_pipelined(ts, g, d)
    assert t._pipe is not None
    for ts, g, d in fr[10:14]:
        system.track(ts, g, d)                     # drains the ring first
    assert t._pipe is None and t._batch_carry is None
    for batch in _batches(fr[14:30]):
        system.track_batch(*batch)
    system.finish()
    assert [f.timestamp for f in t.trajectory] == [ts for ts, _, _ in fr[:30]]
    ts_c, poses = system.camera_trajectory()
    rmse, _ = ate_rmse(ts_c, poses, ds.timestamps, ds.poses_twc)
    assert rmse < 0.05 and t.stats.failures == 0, rmse
    assert len(system.kf_backend_ms) == system.store.count == len(t.keyframes)


@pytest.mark.parametrize("i", [0, 17])
def test_tensor_threshold_gives_the_float_keypoints(frames, i):
    """The detection and the whole feature build at a threshold held in a
    0-dim f32 tensor equal those at the same threshold as a float, bit for
    bit (the batched scan's carry against the serial path's float)."""
    _, fr = frames
    cam = Camera(**CAM_ARGS)
    gray, depth = torch.from_numpy(fr[i][1]), torch.from_numpy(fr[i][2])
    for thr in (15.0, 15.0 * 0.7, 23.4):
        t = torch.tensor(thr, dtype=torch.float32)
        assert torch.equal(fast.fast_corner_mask(gray, thr), fast.fast_corner_mask(gray, t))
        pyr = image.build_pyramid(gray, 3)
        a = fast.detect_keypoints(pyr, 1024, 8, thr, 20.0, 16)
        b = fast.detect_keypoints(pyr, 1024, 8, t, 20.0, 16)
        for name in ("uv", "level", "score", "valid"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        fa = build_frame_features(cam, gray, depth, TCFG.extractor, fast_threshold=thr)
        fb = build_frame_features(cam, gray, depth, TCFG.extractor, fast_threshold=t)
        for name in ("uv", "desc", "xyz", "valid", "surf_cov"):
            assert torch.equal(getattr(fa, name), getattr(fb, name)), name
        assert int(a.valid.sum()) > 100
