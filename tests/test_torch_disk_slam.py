"""Full SLAM of rgbdslam_tpu_torch from a TUM-format directory, map
checkpoints across packages and the batched ADAPTIVE start, against
rgbdslam_tpu (a freiburg1 frame's feature build is in
tests/test_torch_datasets.py).

- The port's CLI reads a 12-frame 320x240 directory written here and must
  give the same run as SlamSystem.track on the same frames quantized in
  memory (the CPU is deterministic: the same keyframes and loops, poses
  within 1e-6), every output file, and the ATE/RPE of groundtruth.txt.
- A map.npz written by either package loads in the other: the same arrays,
  the device bank rebuilt, keyframe 0 verifying against itself.
- A batched ADAPTIVE run whose first frame under-detects builds that frame
  as the JAX package does (the host extractor's re-detections): the same
  keypoints and threshold, exactly.
"""

import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.config import ExtractorConfig as JExtractorConfig
from rgbdslam_tpu.config import SlamConfig as JSlamConfig
from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.io.synthetic import SyntheticDataset as JSyntheticDataset
from rgbdslam_tpu.slam import system as jsystem
from rgbdslam_tpu.slam import tracking as jtracking
from rgbdslam_tpu.utils import serialization as jser
from rgbdslam_tpu_torch import cli, convert
from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, SlamConfig
from rgbdslam_tpu_torch.eval.ate import ate_rmse, rpe
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.io import datasets as tdatasets
from rgbdslam_tpu_torch.io import trajectory as traj_io
from rgbdslam_tpu_torch.io.png import write_png
from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
from rgbdslam_tpu_torch.slam import system as tsystem
from rgbdslam_tpu_torch.slam.tracking import Tracker
from rgbdslam_tpu_torch.utils import serialization as tser

CAM_ARGS = dict(fx=200.0, fy=200.0, cx=159.5, cy=119.5, width=320, height=240)
N_DISK = 12


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test workers run at once: two intra-op threads per process."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """The first 12 frames of tests/test_torch_system.py's orbit, rendered by
    the JAX package and written by the port's PNG writer as a freiburg3
    directory (8-bit grey, 16-bit depth at factor 5000, associations.txt,
    groundtruth.txt), and the frames as the loader returns them."""
    root = tmp_path_factory.mktemp("disk")
    base = str(root / "rgbd_dataset_freiburg3_orbit")
    os.makedirs(base + "/rgb")
    os.makedirs(base + "/depth")
    ds = JSyntheticDataset(n_frames=100, cam=JCamera(**CAM_ARGS), trajectory="orbit",
                           loops=1.15)
    assoc, mem = [], []
    for i in range(N_DISK):
        ts, g, d = ds.grab(i)
        g8 = np.asarray(g).astype(np.uint8)
        d16 = np.clip(np.asarray(d) * 5000.0, 0, 65535).astype(np.uint16)
        rp, dp = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
        write_png(os.path.join(base, rp), g8)
        write_png(os.path.join(base, dp), d16)
        assoc.append(f"{ts:.6f} {rp} {ts:.6f} {dp}")
        mem.append((float(f"{ts:.6f}"), g8.astype(np.float32),
                    d16.astype(np.float32) / 5000.0))
    with open(os.path.join(base, "associations.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")
    traj_io.save_tum(os.path.join(base, "groundtruth.txt"), ds.timestamps[:N_DISK],
                     np.asarray(ds.poses_twc[:N_DISK]))
    return base, mem


def _cli_cfg():
    """The configuration the CLI builds from the flags used below."""
    return SlamConfig(extractor=ExtractorConfig(num_features=512, cell_size=8,
                                                fast_threshold=15.0),
                      loop=LoopConfig(id_interval=4))


def _run_cli(monkeypatch, capsys, argv):
    """cli.main on argv, the directory's camera the 320x240 one its frames
    were rendered with (a freiburg name selects a 640x480 camera); returns
    (the JSON line, stderr, the SlamSystem it built)."""
    built = []
    monkeypatch.setattr(tdatasets, "detect_tum_camera", lambda base_dir: Camera(**CAM_ARGS))

    class Recorded(tsystem.SlamSystem):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    monkeypatch.setattr(tsystem, "SlamSystem", Recorded)
    assert cli.main(argv) == 0
    cap = capsys.readouterr()
    return json.loads(cap.out.strip().splitlines()[-1]), cap.err, (built[0] if built else None)


def _argv(sequence, out, *extra):
    base, _ = sequence
    return ["--dataset", base, "--kind", "TUM", "--device", "cpu",
            "--num-features", "512", "--cell-size", "8", "--fast-threshold", "15",
            "--loop-interval", "4",
            "--out-dir", str(out), *extra]


def test_cli_on_disk_equals_memory(sequence, tmp_path, monkeypatch, capsys):
    base, mem = sequence
    out = tmp_path / "out"
    res, err, sys_d = _run_cli(monkeypatch, capsys, _argv(
        sequence, out, "--save-map", "--export-ply", "--export-octomap", "--export-html",
        "--plot", "--profile"))
    assert res["frames"] == N_DISK and res["loader"] == "cv2"
    for stage in ("track", "octomap", "save_map", "export_ply", "export_html"):
        assert stage in err, stage

    # the same frames in memory, the same configuration and vocabulary
    sys_m = tsystem.SlamSystem(Camera(**CAM_ARGS), _cli_cfg(), device="cpu")
    sys_m.load_vocabulary(shipped_vocabulary("svo_fast"))
    for ts, g, d in mem:
        sys_m.track(ts, g, d)
    sys_m.finish()
    K = sys_m.store.count
    assert res["keyframes"] == K == sys_d.store.count >= 3
    assert res["loops_closed"] == sys_m.loops_closed
    assert sys_d.graph.n_edges == sys_m.graph.n_edges
    ts_d, p_d = sys_d.camera_trajectory()
    ts_m, p_m = sys_m.camera_trajectory()
    np.testing.assert_array_equal(ts_d, ts_m)
    np.testing.assert_allclose(p_d, p_m, rtol=0, atol=1e-6)

    # accuracy against groundtruth.txt, as the CLI reports it
    gts, gposes = traj_io.load_tum(os.path.join(base, "groundtruth.txt"))
    rmse, info = ate_rmse(ts_m, p_m, gts, gposes)
    rpe_t, rpe_r = rpe(ts_m, p_m, gts, gposes)
    assert res["ate_rmse"] == round(rmse, 5) and res["ate_pairs"] == N_DISK
    assert (res["rpe_trans"], res["rpe_rot"]) == (round(rpe_t, 5), round(rpe_r, 5))
    assert rmse < 0.05, rmse

    # the outputs
    names = ("CameraTrajectory.txt", "KeyFrameTrajectory.txt", "map.npz", "map_points.ply",
             "octomap.npz", "octomap_voxels.ply", "map_viewer.html", "trajectory.png")
    for name in names:
        assert (out / name).stat().st_size > 0, name
    head = (out / "map_points.ply").read_text().split("end_header")[0]
    assert f"element vertex {int(sys_d.store.obs_valid[:K].sum())}\n" in head
    assert res["octomap_keyframes"] == K and res["octomap_kf_skipped"] == 0
    assert res["octomap_voxels"] > 100
    ts_c, poses_c = traj_io.load_tum(str(out / "CameraTrajectory.txt"))
    np.testing.assert_allclose(poses_c[:, :3, 3], p_m[:, :3, 3], atol=1e-6)


@pytest.mark.parametrize("mode", [["--ring"], ["--batch", "4"]])
def test_cli_modes_keep_every_keyframe_image(sequence, tmp_path, monkeypatch, capsys, mode):
    """A ring keyframe lands one frame late and a batch's keyframes land at
    its end: every keyframe's images still reach the octomap rebuild."""
    res, _, sys_d = _run_cli(monkeypatch, capsys, _argv(
        sequence, tmp_path, "--export-octomap", "--frames", "6", *mode))
    assert res["frames"] == 6 and res["keyframes"] == sys_d.store.count >= 2
    assert res["octomap_keyframes"] == res["keyframes"] and res["octomap_kf_skipped"] == 0


def test_cli_native_loader_and_its_fallback(sequence, tmp_path, monkeypatch, capsys):
    from rgbdslam_tpu_torch.native import framepipe as fp

    argv = _argv(sequence, tmp_path, "--odometry-only", "--frames", "5", "--native-loader")
    runs = {}
    if fp.native_available():
        runs["native"] = _run_cli(monkeypatch, capsys, argv)[0]
    monkeypatch.setattr(fp, "native_available", lambda: False)
    runs["fallback"], err, _ = _run_cli(monkeypatch, capsys, argv)
    assert "native loader unavailable" in err and runs["fallback"]["loader"] == "cv2"
    if "native" in runs:
        assert runs["native"]["loader"] == "native"
        for k in ("keyframes", "ate_rmse", "failures", "mean_inliers"):
            assert runs["native"][k] == runs["fallback"][k], k


# tests/test_mapping.py::test_map_save_load_roundtrip's camera and extractor
MAP_CAM = dict(fx=80.0, fy=80.0, cx=63.5, cy=47.5, width=128, height=96)
MAP_EX = dict(num_features=256, num_levels=2, cell_size=8, fast_threshold=15.0)


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    """The port's SlamSystem over tests/test_mapping.py's 10 sweep frames and
    its map.npz; that file loaded by the JAX package into a fresh JAX
    SlamSystem, and the map.npz the JAX package writes from it."""
    root = tmp_path_factory.mktemp("maps")
    jcfg = JSlamConfig(extractor=JExtractorConfig(**MAP_EX))
    ds = JSyntheticDataset(n_frames=10, cam=JCamera(**MAP_CAM), trajectory="sweep")
    st = tsystem.SlamSystem(Camera(**MAP_CAM), convert.config_from_jax(jcfg), device="cpu")
    for i in range(len(ds)):
        ts, g, d = ds.grab(i)
        st.track(ts, np.asarray(g), np.asarray(d))
    pt, pj = str(root / "port.npz"), str(root / "jax.npz")
    tser.save_map(pt, st)
    sj = jsystem.SlamSystem(JCamera(**MAP_CAM), jcfg, seed=0)
    jser.load_map(pt, sj)
    jser.save_map(pj, sj)
    return jcfg, st, sj, pt, pj


def _assert_same_map(a, b):
    """Store, graph and loop-detector state of two systems (either package)."""
    K, E = a.store.count, a.graph.n_edges
    assert (b.store.count, b.graph.n_edges, b.graph.n_vertices) == (K, E, K)
    for f in ("desc", "xyz", "obs_valid", "uv", "intensity", "poses_cw", "timestamps"):
        np.testing.assert_array_equal(getattr(b.store, f)[:K], getattr(a.store, f)[:K], f)
    for f in ("e_a", "e_b", "e_Z", "e_w"):
        np.testing.assert_array_equal(getattr(b.graph, f)[:E], getattr(a.graph, f)[:E], f)
    assert b.loop_detector._connections == a.loop_detector._connections
    assert b.tracker.stats.frames == a.tracker.stats.frames
    np.testing.assert_allclose(b.camera_trajectory()[1], a.camera_trajectory()[1], atol=1e-5)


def test_map_from_port_loads_in_jax(maps):
    _jcfg, st, sj, pt, pj = maps
    assert st.store.count >= 4 and st.loop_detector.words is not None
    _assert_same_map(st, sj)
    K = sj.store.count
    # the JAX package rebuilt its device bank from the restored store
    np.testing.assert_array_equal(np.asarray(sj._bank[0])[:K], st.store.desc[:K])
    np.testing.assert_array_equal(np.asarray(sj.loop_detector.words),
                                  st.loop_detector.words.numpy().view(np.uint32))

    class _F:
        desc = jnp.asarray(st.store.desc[0])
        xyz = jnp.asarray(st.store.xyz[0])
        obs_valid = jnp.asarray(st.store.obs_valid[0])

    _T, _ninl, ok, nm = sj._verify_candidates([0], _F)
    assert bool(ok[0]) and int(nm[0]) > 50, int(nm[0])
    # one layout: the same keys, dtypes and arrays in both packages' files
    with np.load(pt) as a, np.load(pj) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_map_from_jax_loads_in_port(maps):
    jcfg, st, sj, _pt, pj = maps
    s2 = tsystem.SlamSystem(Camera(**MAP_CAM), convert.config_from_jax(jcfg), device="cpu")
    tser.load_map(pj, s2)
    _assert_same_map(sj, s2)
    K = s2.store.count
    # the device bank rebuilt from the store, the codebook restored
    np.testing.assert_array_equal(s2._bank[0][:K].numpy().view(np.uint32), s2.store.desc[:K])
    np.testing.assert_array_equal(s2._bank[1][:K].numpy(), s2.store.xyz[:K])
    np.testing.assert_array_equal(s2._bank[2][:K].numpy(), s2.store.obs_valid[:K])
    np.testing.assert_array_equal(s2.loop_detector.words.numpy().view(np.uint32),
                                  np.asarray(sj.loop_detector.words))
    np.testing.assert_array_equal(s2._bank[3][:K].numpy(), sj.loop_detector.bow_db[:K])
    f0 = types.SimpleNamespace(desc=s2._bank[0][0], xyz=s2._bank[1][0],
                               obs_valid=s2._bank[2][0])
    _T, _ninl, ok, nm = s2._verify_candidates([0], f0)
    assert bool(ok[0]) and int(nm[0]) > 50, int(nm[0])


def test_batched_adaptive_first_frame_equals_jax():
    """A batch started at threshold 60 under-detects its first frame: both
    packages re-detect it on the host (x0.7 per round), so keyframe 0's
    keypoints and the threshold the device scan starts from agree exactly
    (one frame: the JAX dispatch returns before its scan; the scan's own
    threshold updates are held in tests/test_torch_batch_ring.py)."""
    ds = JSyntheticDataset(n_frames=48, cam=JCamera(**CAM_ARGS), trajectory="orbit")
    ts, g, d = ds.grab(0)
    fr = ([ts], [np.asarray(g)], [np.asarray(d)])
    jcfg = JSlamConfig(extractor=JExtractorConfig(num_features=128, num_levels=2, cell_size=8,
                                                  fast_threshold=60.0, adapt_target_min=60,
                                                  adapt_target_max=120),
                       adaptive=True)
    jt = jtracking.Tracker(JCamera(**CAM_ARGS), jcfg, seed=0)
    jt.track_batch_complete(jt.track_batch_dispatch(*fr))
    tt = Tracker(Camera(**CAM_ARGS), convert.config_from_jax(jcfg), seed=0, device="cpu")
    tt.track_batch_complete(tt.track_batch_dispatch(*fr))
    ex = tt._extractor
    assert ex.threshold == jt._extractor.threshold < 60.0 * 0.7 and ex.reads >= 2
    assert tt._batch_carry[2].item() == np.float32(ex.threshold)
    kj, kt = jt.keyframes[0][1], tt.keyframes[0][1]
    for k in ("uv", "level", "valid", "desc"):
        a = getattr(kt, k).numpy()
        b = np.asarray(getattr(kj, k))
        np.testing.assert_array_equal(a.view(np.uint32) if k == "desc" else a, b, err_msg=k)
    assert np.asarray(kj.valid).sum() >= 60


def test_stage_timer_and_device_trace(tmp_path):
    """utils/profiling.py: stage means and the report, and a torch.profiler
    trace written where asked (nothing without a directory)."""
    from rgbdslam_tpu_torch.utils.profiling import StageTimer, device_trace

    timer = StageTimer(sync=True)
    for _ in range(3):
        with timer.stage("a", sync_result=torch.ones(2)):
            pass
    with timer.stage("b"):
        torch.ones(4).sum()
    assert timer.count["a"] == 3 and timer.count["b"] == 1
    assert timer.mean_ms("a") >= 0 and timer.report().splitlines()[0].split()[0] in "ab"
    with device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with device_trace(None):
        pass
