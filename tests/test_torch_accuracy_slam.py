"""The accuracy path of full SLAM in rgbdslam_tpu_torch against rgbdslam_tpu:
the dense-ICP polish in serial, ring and batched modes, local (sliding
window) and global bundle adjustment, and the CLI's accuracy flags.

Both packages see the same pixels: the first 12 frames of the 128-frame
multi-room tour with a real revisit (loops=1.15; tests/test_system.py's
320x240 camera and configuration at 512 features), rendered once by the JAX
package, with dense ICP, local BA and global BA all on (one run of each
package and mode covers all three, to keep the file's time). Their RANSAC
draws differ (jax.random against torch.Generator), so whole runs are held
by accuracy and counts: ATEs under tests/test_system.py's 0.06 m and within
0.02 m of each other, keyframe counts within 10 %, BA solve counts equal.
Within the port the ring and the batches are held against its serial run by
tests/test_torch_batch_ring.py's bounds. 12 frames reach no loop closure:
global BA runs at `finish()` here, after each closed loop on the card
(chip_smoke.py phase 9).
"""

import contextlib
import json

import numpy as np
import pytest

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.config import ExtractorConfig as JExtractorConfig
from rgbdslam_tpu.config import LoopConfig as JLoopConfig
from rgbdslam_tpu.config import SlamConfig as JSlamConfig
from rgbdslam_tpu.eval.ate import ate_rmse as j_ate
from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.io.synthetic import SyntheticDataset as JSyntheticDataset
from rgbdslam_tpu.loop.vocabulary import shipped_vocabulary as j_shipped
from rgbdslam_tpu.slam import system as jsystem
from rgbdslam_tpu.solvers import ba as jba
from rgbdslam_tpu_torch import cli, convert
from rgbdslam_tpu_torch.eval.ate import ate_rmse
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
from rgbdslam_tpu_torch.slam import system as system_mod
from rgbdslam_tpu_torch.slam import tracking
from rgbdslam_tpu_torch.slam.system import SlamSystem
from rgbdslam_tpu_torch.slam.tracking import TrackerState
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM_ARGS = dict(fx=200.0, fy=200.0, cx=159.5, cy=119.5, width=320, height=240)
# tests/test_system.py's extractor at 512 features (time), every accuracy
# feature on at once: dense ICP, local BA and global BA (with four rounds,
# as tests/test_system.py::test_system_global_ba)
JCFG = JSlamConfig(extractor=JExtractorConfig(num_features=512, num_levels=3, cell_size=8,
                                              fast_threshold=15.0),
                   loop=JLoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=256),
                   use_dense_icp=True, use_local_ba=True, use_global_ba=True,
                   global_ba_iterations=4)
TCFG = convert.config_from_jax(JCFG)
N_FRAMES, B = 12, 8


@pytest.fixture(scope="module")
def frames():
    """The tour's first 12 frames rendered once by the JAX package, as numpy."""
    ds = JSyntheticDataset(n_frames=128, cam=JCamera(**CAM_ARGS), trajectory="tour",
                           loops=1.15)
    out = []
    for i in range(N_FRAMES):
        ts, g, d = ds.grab(i)
        out.append((float(ts), np.asarray(g), np.asarray(d)))
    return ds, out


def _port():
    system = SlamSystem(Camera(**CAM_ARGS), TCFG, seed=0, device="cpu")
    system.load_vocabulary(shipped_vocabulary("svo_fast"))
    return system


def _ate(system, ds):
    ts, poses = system.camera_trajectory()
    rmse, info = ate_rmse(ts, poses, ds.timestamps[:N_FRAMES], ds.poses_twc[:N_FRAMES])
    assert info["pairs"] == N_FRAMES and np.isfinite(poses).all()
    return rmse, poses


def _device_rule_keyframes(system):
    """The keyframes the batched scan's gate picks on a run's tracked poses
    (motion since the last keyframe D = Tcw_cur Twc_kf beyond the keyframe
    thresholds): what a batch is held to, since the serial gate measures
    inverse(Tcw_cur) Tcw_kf instead (ROADMAP fault F1; chip_smoke.py phase 7
    holds batches the same way)."""
    kf_cfg = system.cfg.keyframe
    traj = system.tracker.trajectory
    last, n = traj[0].Tcw, 1
    for fr in traj[1:]:
        D = fr.Tcw @ np.linalg.inv(last)
        rn = np.arccos(np.clip(0.5 * (np.trace(D[:3, :3]) - 1.0), -1.0, 1.0))
        if np.linalg.norm(D[:3, 3]) > kf_cfg.min_translation or rn > kf_cfg.min_rotation:
            n, last = n + 1, fr.Tcw
    return n


@contextlib.contextmanager
def _counting(module, name, counts, key_of):
    """Replace module.name by a wrapper that counts its calls in `counts`
    under key_of(args, kwargs)."""
    real = getattr(module, name)

    def counted(*a, **k):
        key = key_of(a, k)
        counts[key] = counts.get(key, 0) + 1
        return real(*a, **k)

    setattr(module, name, counted)
    try:
        yield
    finally:
        setattr(module, name, real)


@pytest.fixture(scope="module")
def serial_run(frames):
    """The port's serial run, its dense polishes counted."""
    system, polished = _port(), {}
    with _counting(tracking, "dense_icp", polished, lambda a, k: "polish"):
        for ts, g, d in frames[1]:
            system.track(ts, g, d)
    system.finish()
    return system, polished.get("polish", 0)


@pytest.fixture(scope="module")
def jax_run(frames):
    """The JAX package's serial run, its BA solves counted (local: without
    edges, global: with)."""
    calls = {}
    system = jsystem.SlamSystem(JCamera(**CAM_ARGS), JCFG, seed=0)
    system.load_vocabulary(j_shipped("svo_fast"))
    with _counting(jba, "local_ba", calls,
                   lambda a, k: "global" if k.get("edges") is not None else "local"):
        for ts, g, d in frames[1]:
            system.track(ts, g, d)
        system.finish()
    return system, calls


def test_serial_matches_jax(frames, serial_run, jax_run):
    """Serial tracking with the dense polish and both BAs: one polish per
    successful estimate (no second-reference retry on this tour), a local
    BA solve at keyframes from the fifth on (none where the keyframe carries
    loop candidates), a global one at `finish()`, as many of each as the
    JAX package makes on the same frames; both runs within
    tests/test_system.py's 0.06 m and within 0.02 m of each other, keyframe
    counts within 10 %."""
    ds = frames[0]
    st, n_polished = serial_run
    sj, calls = jax_run
    rt, _ = _ate(st, ds)
    ts_j, poses_j = sj.camera_trajectory()
    rj, _ = j_ate(ts_j, poses_j, ds.timestamps[:N_FRAMES], ds.poses_twc[:N_FRAMES])
    assert rt < 0.06 and rj < 0.06 and abs(rt - rj) < 0.02, (rt, rj)
    assert abs(st.store.count - sj.store.count) <= 0.1 * sj.store.count
    stats = st.tracker.stats
    assert stats.failures == 0 and st.tracker.state is TrackerState.OK
    assert stats.estimates == N_FRAMES - 1 and n_polished == N_FRAMES - 1
    assert st.tracker.ref_depth is st.tracker._cur_depth is not None
    assert st.store.count == sj.store.count
    assert len(st.local_ba_ms) == calls["local"] > 0
    assert len(st.global_ba_ms) == calls["global"] == 1
    # the solves moved the map: the graph's vertices follow the store
    K = st.store.count
    np.testing.assert_allclose(st.graph.Twc[:K] @ st.store.poses_cw[:K],
                               np.tile(np.eye(4), (K, 1, 1)), atol=1e-4)


def test_ring_and_batch_match_serial(frames, serial_run):
    """The ring polishes inside its enqueued step against the previous
    frame's depth, the batch against the depth in its carry (seeded from the
    batch's first frame): tests/test_torch_batch_ring.py's bounds against
    the serial run (the ring: the same keyframes, failures and inliers,
    positions within 0.02 m; the batch: ATE below max(1.5 x serial's,
    0.05 m), keyframes within 20 % + 1 of what its device gate picks on the
    serial run's poses). Both run the backend's BA as well."""
    ds, fr = frames
    s1 = serial_run[0]
    r1, p1 = _ate(s1, ds)

    ring = _port()
    for ts, g, d in fr:
        ring.track_pipelined(ts, g, d)
    ring.track_pipelined_flush()
    ring.finish()
    r2, p2 = _ate(ring, ds)
    assert ring.store.count == s1.store.count
    assert ring.tracker.stats.failures == s1.tracker.stats.failures
    assert ([f.num_inliers for f in ring.tracker.trajectory]
            == [f.num_inliers for f in s1.tracker.trajectory])
    assert float(np.linalg.norm(p2[:, :3, 3] - p1[:, :3, 3], axis=-1).max()) < 0.02
    assert ring.tracker.ref_depth is not None
    assert len(ring.local_ba_ms) == len(s1.local_ba_ms)

    batch = _port()
    for i in range(0, N_FRAMES, B):
        chunk = fr[i:i + B]
        batch.track_batch(*zip(*chunk))
        carry = batch.tracker._batch_carry
        # the carry holds the batch's last depth (fault F3 repaired)
        assert carry[2].shape == (CAM_ARGS["height"], CAM_ARGS["width"])
        np.testing.assert_array_equal(carry[2].numpy(), chunk[-1][2])
        assert batch.tracker.ref_depth is carry[2]
    batch.finish()
    r3, _ = _ate(batch, ds)
    K_rule = _device_rule_keyframes(s1)
    assert abs(batch.store.count - K_rule) <= 0.2 * K_rule + 1, (batch.store.count, K_rule)
    assert r1 < 0.06 and r2 < 0.06 and r3 < max(1.5 * r1, 0.05), (r1, r2, r3)
    assert len(batch.global_ba_ms) == 1


@pytest.mark.parametrize("flag", ["--dense-icp", "--noise-robust", "--local-ba", "--global-ba"])
def test_cli_accuracy_flags_run_on_cpu(tmp_path, capsys, flag):
    """Each accuracy flag end to end through the CLI on the CPU (a 160x120
    sweep of 16 frames): the JSON line, the flag in effect (dense polishes
    and BA solves counted)."""
    calls = {}
    argv = ["--dataset", "synthetic:sweep", "--frames", "16", "--loop-interval", "12",
            "--device", "cpu", "--width", "160", "--height", "120", "--cell-size", "8",
            "--fast-threshold", "15", "--num-features", "256", "--out-dir", str(tmp_path),
            flag]
    with _counting(tracking, "dense_icp", calls, lambda a, k: "polish"), \
            _counting(system_mod, "local_ba", calls,
                      lambda a, k: "global" if k.get("edges") is not None else "local"):
        assert cli.main(argv) == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert out["frames"] == 16 and out["keyframes"] >= 5 and out["ate_rmse"] < 0.05
    dense = flag in ("--dense-icp", "--noise-robust")
    assert (calls.get("polish", 0) > 0) == dense
    assert (calls.get("local", 0) > 0) == (flag == "--local-ba")
    assert calls.get("global", 0) == (1 if flag == "--global-ba" else 0)
    if flag == "--noise-robust":
        assert "vocabulary:" in captured.err
