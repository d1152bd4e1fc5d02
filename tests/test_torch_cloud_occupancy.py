"""Keyframe clouds, the occupancy grid, the octomap rebuild and the PLY/HTML
writers of rgbdslam_tpu_torch against rgbdslam_tpu, on the same frames.

Integer results are held exactly: voxel keys, the sort order, segment counts
and validity, the endpoint voxels of the occupancy scatter. Float sums are
held to f32 tolerances. Two comparisons are bounded by counts instead:

- the SOR keep mask may differ only for points whose mean k-NN distance lies
  within f32 rounding of the threshold (counted in float64 here);
- XLA contracts the ray sample pts * t + origin * (1 - t) into a fused
  multiply-add, the port rounds the product first, so a sample within
  float rounding of a voxel face may land in the neighbouring voxel: the
  visited voxels may differ by at most two per such sample (counted here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.config import KeyframeConfig as JKeyframeConfig
from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.io.synthetic import SyntheticDataset as JSyntheticDataset
from rgbdslam_tpu.mapping import cloud as jcloud
from rgbdslam_tpu.mapping import occupancy as jocc
from rgbdslam_tpu.viz import export as jexport
from rgbdslam_tpu.viz import octomap_export as joct
from rgbdslam_tpu_torch.config import KeyframeConfig
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.mapping import cloud as tcloud
from rgbdslam_tpu_torch.mapping import occupancy as tocc
from rgbdslam_tpu_torch.viz import export as texport
from rgbdslam_tpu_torch.viz import octomap_export as toct

CAM_ARGS = dict(fx=200.0, fy=200.0, cx=159.5, cy=119.5, width=320, height=240)
MAX_POINTS = 2048      # 320x240 at stride 6 gives at most 2,160 points


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test workers run at once: two intra-op threads per process."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """Orbit frames rendered by the JAX package, quantized as a 16-bit depth
    PNG at factor 5000 and an 8-bit grey PNG would store them; their
    ground-truth Tcw."""
    ds = JSyntheticDataset(n_frames=48, cam=JCamera(**CAM_ARGS), trajectory="orbit")
    out = []
    for i in (0, 6, 12, 18):
        _, g, d = ds.grab(i)
        g = np.asarray(g).astype(np.uint8).astype(np.float32)
        d = np.clip(np.asarray(d) * 5000.0, 0, 65535).astype(np.uint16).astype(np.float32)
        out.append((g, d / 5000.0, np.linalg.inv(np.asarray(ds.poses_twc[i]))))
    return out


def _jcloud(c):
    return jcloud.Cloud(xyz=jnp.asarray(c[0]), intensity=jnp.asarray(c[1]),
                        valid=jnp.asarray(c[2]))


def _tcloud(c):
    return tcloud.Cloud(xyz=torch.from_numpy(np.array(c[0])),
                        intensity=torch.from_numpy(np.array(c[1])),
                        valid=torch.from_numpy(np.array(c[2])))


def _np(c):
    return tuple(np.asarray(a) for a in c)


def _sor_near_threshold(xyz, valid, k=50, std_mul=1.0, rel=1e-5):
    """Points whose mean k-NN distance lies within `rel` of the SOR
    threshold, both computed in float64."""
    p = xyz.astype(np.float64)
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    d2[~(valid[:, None] & valid[None, :])] = np.inf
    np.fill_diagonal(d2, np.inf)
    near = np.sort(d2, axis=1)[:, :k]
    ok = np.isfinite(near)
    mean_d = np.where(ok, np.sqrt(np.where(ok, near, 0)), 0).sum(1) / np.maximum(ok.sum(1), 1)
    mu = mean_d[valid].mean()
    thresh = mu + std_mul * mean_d[valid].std()
    return valid & (np.abs(mean_d - thresh) <= rel * thresh)


def test_create_cloud_and_voxel_keys_exact(frames):
    g, d, _ = frames[0]
    cj = _np(jcloud.create_cloud(JCamera(**CAM_ARGS), jnp.asarray(g), jnp.asarray(d), 6))
    ct = _np(tcloud.create_cloud(Camera(**CAM_ARGS), torch.from_numpy(g), torch.from_numpy(d),
                                 6))
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(a, b)
    assert cj[2].sum() > 1000
    # the int32 key wraps: its shifts overflow for every point here
    kj = np.asarray(jcloud._voxel_key(jnp.asarray(cj[0]), 0.04))
    kt = tcloud.voxel_key(torch.from_numpy(cj[0]), 0.04).numpy()
    np.testing.assert_array_equal(kt, kj)
    assert (kj < 0).any() and (kj > 0).any()


@pytest.mark.parametrize("voxel", [0.04, 0.1])
def test_voxel_downsample_matches(frames, voxel):
    g, d, _ = frames[1]
    c = _np(jcloud.create_cloud(JCamera(**CAM_ARGS), jnp.asarray(g), jnp.asarray(d), 6))
    vj = _np(jcloud.voxel_downsample(_jcloud(c), MAX_POINTS, voxel))
    vt = _np(tcloud.voxel_downsample(_tcloud(c), MAX_POINTS, voxel))
    np.testing.assert_array_equal(vt[2], vj[2])          # the segment count and order
    assert 50 < vj[2].sum() < MAX_POINTS
    np.testing.assert_allclose(vt[0][vj[2]], vj[0][vj[2]], rtol=0, atol=2e-6)
    np.testing.assert_allclose(vt[1][vj[2]], vj[1][vj[2]], rtol=0, atol=1e-4)


def test_voxel_downsample_budget_overflow(frames):
    """More voxels than the budget: the excess merges into the last slot in
    both packages."""
    g, d, _ = frames[2]
    c = _np(jcloud.create_cloud(JCamera(**CAM_ARGS), jnp.asarray(g), jnp.asarray(d), 6))
    vj = _np(jcloud.voxel_downsample(_jcloud(c), 64, 0.04))
    vt = _np(tcloud.voxel_downsample(_tcloud(c), 64, 0.04))
    np.testing.assert_array_equal(vt[2], vj[2])
    assert vj[2].all()
    np.testing.assert_allclose(vt[0], vj[0], rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("i", [0, 3])
def test_statistical_outlier_removal_matches(frames, i):
    g, d, _ = frames[i]
    c = _np(jcloud.voxel_downsample(jcloud.create_cloud(
        JCamera(**CAM_ARGS), jnp.asarray(g), jnp.asarray(d), 6), MAX_POINTS, 0.04))
    kj = np.asarray(jcloud.statistical_outlier_removal(_jcloud(c), 50, 1.0).valid)
    kt = tcloud.statistical_outlier_removal(_tcloud(c), 50, 1.0).valid.numpy()
    near = _sor_near_threshold(c[0], c[2])
    flips = kj != kt
    assert not (flips & ~near).any(), (int(flips.sum()), int(near.sum()))
    assert 0 < (c[2] & ~kj).sum() < 0.5 * c[2].sum()       # some points dropped, most kept


def test_keyframe_cloud_and_transform_match(frames):
    g, d, Tcw = frames[3]
    Twc = np.linalg.inv(Tcw).astype(np.float32)
    kw = dict(stride=6, z_min=0.5, z_max=4.0, voxel=0.04, sor_k=50, sor_std=1.0,
              max_points=MAX_POINTS)
    cj = jcloud.transform_cloud(jcloud.keyframe_cloud(
        JCamera(**CAM_ARGS), jnp.asarray(g), jnp.asarray(d), **kw), jnp.asarray(Twc))
    ct = tcloud.transform_cloud(tcloud.keyframe_cloud(
        Camera(**CAM_ARGS), torch.from_numpy(g), torch.from_numpy(d), **kw),
        torch.from_numpy(Twc))
    cj, ct = _np(cj), _np(ct)
    flips = cj[2] != ct[2]
    assert flips.sum() <= 2, int(flips.sum())
    both = cj[2] & ct[2]
    np.testing.assert_allclose(ct[0][both], cj[0][both], rtol=0, atol=1e-5)
    assert int(ct[2].sum()) == int(tcloud.Cloud(*map(torch.from_numpy, ct)).count)


def _near_face_samples(pts, valid, origin, res, sensor, n_steps=64, rel=1e-5):
    """Ray samples (of valid points) within rel * res of a voxel face, in
    float64."""
    ts = (np.arange(n_steps) + 0.5) / n_steps
    ray = (pts.astype(np.float64)[None] * ts[:, None, None]
           + sensor.astype(np.float64)[None, None] * (1 - ts[:, None, None]))
    f = (ray - origin.astype(np.float64)) / res
    close = np.abs(f - np.round(f)) < rel
    return int((close.any(-1) & valid[None]).sum())


def _grid_inputs(frames, i):
    g, d, Tcw = frames[i]
    Twc = np.linalg.inv(Tcw).astype(np.float32)
    c = _np(jcloud.transform_cloud(jcloud.keyframe_cloud(
        JCamera(**CAM_ARGS), jnp.asarray(g), jnp.asarray(d), max_points=MAX_POINTS),
        jnp.asarray(Twc)))
    return c, Twc


def test_insert_cloud_matches(frames):
    lo, hi = np.array([-3.0, -2.5, -3.2], np.float32), np.array([3.1, 2.4, 3.3], np.float32)
    gj, gt = jocc.make_grid(lo, hi, 0.08), tocc.make_grid(lo, hi, 0.08, device="cpu")
    assert tuple(gt.log_odds.shape) == gj.log_odds.shape
    n_near = 0
    for i in range(3):
        c, Twc = _grid_inputs(frames, i)
        o = Twc[:3, 3]
        gj = jocc.insert_cloud(gj, _jcloud(c), jnp.asarray(o))
        gt = tocc.insert_cloud(gt, _tcloud(c), torch.from_numpy(o))
        n_near += _near_face_samples(c[0], c[2], lo, 0.08, o)
    lj, lt = np.asarray(gj.log_odds), gt.log_odds.numpy()
    # endpoints: no product is rounded, so hits and colour counts are exact
    np.testing.assert_array_equal(gt.color_cnt.numpy(), np.asarray(gj.color_cnt))
    np.testing.assert_allclose(gt.color_sum.numpy(), np.asarray(gj.color_sum),
                               rtol=1e-6, atol=1e-3)
    n_diff = int((lj != lt).sum())
    assert n_diff <= 2 * n_near, (n_diff, n_near)
    assert (lj > 0).sum() > 500 and (lj < 0).sum() > 5000
    oj, ot = jocc.occupied_voxels(gj), tocc.occupied_voxels(gt)
    assert abs(len(oj[0]) - len(ot[0])) <= n_diff
    print(f"near-face samples {n_near}, voxels that differ {n_diff}")


@pytest.mark.parametrize("threshold", [0.9, 0.7, 0.999])
def test_occupied_cut_equals_jax_sigmoid(threshold):
    """occupied_voxels cuts the grid in log-odds on its own device: the cut
    makes the JAX package's decision, sigmoid(x) >= threshold in float32,
    on every float32 within 1e-3 of logit(threshold) and on the hit-once
    value logit(0.9)."""
    x0 = np.float32(np.log(threshold / (1 - threshold)))
    v = np.linspace(x0 - 1e-3, x0 + 1e-3, 1 << 16, dtype=np.float32)
    v = np.concatenate([v, np.nextafter(x0, np.float32(-np.inf)) + np.zeros(16, np.float32),
                        x0 + np.zeros(16, np.float32), np.float32(2.1972246) + np.zeros(16)])
    v = v.astype(np.float32)
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(v))) >= threshold
    got = v >= tocc.occupied_from(threshold)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(v)


@pytest.mark.parametrize("sparse", [False, True])
def test_grid_files_cross_packages(frames, tmp_path, sparse):
    c, Twc = _grid_inputs(frames, 0)
    lo, hi = np.array([-3.0, -2.5, -3.2], np.float32), np.array([3.1, 2.4, 3.3], np.float32)
    gj = jocc.insert_cloud(jocc.make_grid(lo, hi, 0.08), _jcloud(c), jnp.asarray(Twc[:3, 3]))
    cap = 10**6 if sparse else None
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jocc.save_grid(pj, gj, extra={"epoch": 3}, sparse_cap=cap)
    # the port loads the JAX file and writes it again: the same arrays, keys
    # and dtypes, and the JAX package loads the port's file
    gt = tocc.load_grid(pj, device="cpu")
    np.testing.assert_array_equal(gt.log_odds.numpy(), np.asarray(gj.log_odds))
    tocc.save_grid(pt, gt, extra={"epoch": 3}, sparse_cap=cap)
    with np.load(pj) as a, np.load(pt) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    g2 = jocc.load_grid(pt)
    for f in ("log_odds", "color_sum", "color_cnt", "origin"):
        np.testing.assert_array_equal(np.asarray(getattr(g2, f)), np.asarray(getattr(gj, f)))
    cj, ct = jocc.occupied_voxels(gj), tocc.occupied_voxels(gt)
    np.testing.assert_array_equal(ct[0], cj[0])
    np.testing.assert_array_equal(ct[1], cj[1])
    assert len(cj[0]) > 100


def test_octomap_rebuild_and_incremental_builder(frames):
    kf_cfg = KeyframeConfig()
    ims = {k: (g, d) for k, (g, d, _) in enumerate(frames[:3])}
    poses = np.stack([Tcw for _, _, Tcw in frames[:3]]).astype(np.float32)
    gj = joct.build_occupancy_from_keyframes(JCamera(**CAM_ARGS), ims, poses,
                                             JKeyframeConfig(), max_points=MAX_POINTS)
    gt = toct.build_occupancy_from_keyframes(Camera(**CAM_ARGS), ims, poses, kf_cfg,
                                             max_points=MAX_POINTS, device="cpu")
    assert tuple(gt.log_odds.shape) == gj.log_odds.shape
    np.testing.assert_array_equal(gt.origin.numpy(), np.asarray(gj.origin))
    lj, lt = np.asarray(gj.log_odds), gt.log_odds.numpy()
    assert (lj != lt).mean() < 1e-3, int((lj != lt).sum())
    # the live builder: the 64-cell dims buckets, a bounds overflow and an
    # epoch advance rebuild, new keyframes only otherwise
    bj = joct.IncrementalOccupancyBuilder(max_points=MAX_POINTS)
    bt = toct.IncrementalOccupancyBuilder(max_points=MAX_POINTS, device="cpu")
    for keys, epoch, rebuilt in (([0], 0, True), ([0, 1], 0, False), ([0, 1, 2], 1, True)):
        sub = {k: ims[k] for k in keys}
        rj, _ = bj.update(JCamera(**CAM_ARGS), sub, poses, epoch, JKeyframeConfig())
        rt, _ = bt.update(Camera(**CAM_ARGS), sub, poses, epoch, kf_cfg)
        assert tuple(rt.log_odds.shape) == rj.log_odds.shape
        assert all(s % 64 in (0, 1, 63) for s in rt.log_odds.shape)
        np.testing.assert_array_equal(bt._lo, bj._lo)
        assert bt.ids == bj.ids and bt.epoch == bj.epoch
        diff = np.asarray(rj.log_odds) != rt.log_odds.numpy()
        assert diff.mean() < 1e-3, int(diff.sum())


def test_keyframe_image_keeper_thins_alike():
    kj, kt = joct.KeyframeImageKeeper(max_frames=4), toct.KeyframeImageKeeper(max_frames=4)
    for k in range(13):
        a = np.full((2, 2), k, np.float32)
        kj.offer(k, a, a)
        kt.offer(k, a, a)
    assert sorted(kt.images) == sorted(kj.images) and kt._skip == kj._skip
    t = torch.zeros(2, 2)
    kt.offer(16, t, t)
    assert kt.images[16][0] is t          # a tensor is kept by reference


def test_ply_and_html_bytes_equal(tmp_path):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    inten = rng.uniform(-10, 300, 300).astype(np.float32)
    valid = rng.uniform(size=300) > 0.3
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(5, 3))
    for name, args in (("a.ply", (xyz, inten, valid)), ("b.ply", (xyz,)),
                       ("c.ply", (xyz, inten))):
        assert texport.save_ply(str(tmp_path / ("t" + name)), *args) == \
            jexport.save_ply(str(tmp_path / ("j" + name)), *args)
        assert (tmp_path / ("t" + name)).read_bytes() == (tmp_path / ("j" + name)).read_bytes()
    for kw in ({}, {"max_points": 100}):
        texport.save_html_viewer(str(tmp_path / "t.html"), xyz, inten, poses, **kw)
        jexport.save_html_viewer(str(tmp_path / "j.html"), xyz, inten, poses, **kw)
        assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    texport.save_html_viewer(str(tmp_path / "t.html"), xyz)
    jexport.save_html_viewer(str(tmp_path / "j.html"), xyz)
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()


def test_overlays_and_quick_plot(tmp_path):
    from rgbdslam_tpu_torch.io.png import read_png

    g = np.full((32, 32), 100.0, np.float32)
    uv = np.array([[5.0, 5.0], [20.0, 20.0], [100.0, 5.0]])
    args = (g, uv, np.array([True, False, True]), np.array([True, True, True]))
    np.testing.assert_array_equal(texport.draw_tracked_points(*args),
                                  jexport.draw_tracked_points(*args))
    m = (g, uv, g, uv[::-1], np.array([2, 1, 0]), np.array([True, True, False]))
    np.testing.assert_array_equal(texport.draw_matches(*m), jexport.draw_matches(*m))
    poses = np.tile(np.eye(4, dtype=np.float32), (20, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 1, 20)
    poses[:, 2, 3] = np.sin(np.linspace(0, 3, 20))
    p = str(tmp_path / "q.png")
    texport.plot_trajectory_quick(p, poses, size=64)
    img = read_png(p)
    assert img.shape == (64, 64, 3) and (img != 255).any()


def test_live_export_writes_during_the_run(tmp_path):
    """SlamSystem.live_export: the worker thread rewrites the viewer, the
    trajectory, the overlay and the occupancy grid during the run; finish()
    makes the last export and drains the worker."""
    from rgbdslam_tpu_torch.config import ExtractorConfig, SlamConfig
    from rgbdslam_tpu_torch.slam.system import SlamSystem

    ds = JSyntheticDataset(n_frames=100, cam=JCamera(**CAM_ARGS), trajectory="orbit",
                           loops=1.15)
    cfg = SlamConfig(extractor=ExtractorConfig(num_features=512, num_levels=3, cell_size=8,
                                               fast_threshold=15.0))
    system = SlamSystem(Camera(**CAM_ARGS), cfg, device="cpu")
    system.live_export = (1, str(tmp_path), 0.0)      # every keyframe, no time floor
    for i in range(8):
        ts, g, d = ds.grab(i)
        system.track(ts, np.asarray(g), np.asarray(d))
    system.finish()
    assert system.live_export_errors == []
    assert system.live_exports_written >= 2
    assert system.live_exports_written + system.live_exports_dropped >= system.store.count
    for name in ("map_viewer.html", "trajectory.png", "overlay.png", "octomap.npz"):
        assert (tmp_path / name).stat().st_size > 0, name
    assert not list(tmp_path.glob("*.tmp*"))
    with np.load(tmp_path / "octomap.npz") as f:
        assert "sparse_idx" in f.files and int(f["epoch"]) == system.map_epoch
    grid = tocc.load_grid(str(tmp_path / "octomap.npz"), device="cpu")
    assert len(tocc.occupied_voxels(grid)[0]) > 100
    assert all(s % 64 in (0, 1, 63) for s in grid.log_odds.shape)
