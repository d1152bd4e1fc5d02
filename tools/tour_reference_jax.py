"""Run the JAX package's serial full SLAM on the synthetic multi-room tour on
the CPU and print its accuracy record: ATE, keyframes, loops, failures.

  python tools/tour_reference_jax.py [--frames 128] [--seeds 0 1 2]
  python tools/tour_reference_jax.py --loops 1.15 --noise --config noise-robust
  python tools/tour_reference_jax.py --loops 1.15 --detector sift --seeds 0
  python tools/tour_reference_jax.py --loops 1.15 --detector orb --batch 8
  python tools/tour_reference_jax.py --loops 1.15 --detector orb --config cell6 --seeds 0
  python tools/tour_reference_jax.py --sweep --config euclidean --seeds 0 1 2 3 4
  python tools/tour_reference_jax.py --sweep --slam --detector orb --config cell40 --seeds 0 1 2
  python tools/tour_reference_jax.py --merge

The configuration is the one chip_smoke.py drives through the PyTorch port
on the GPU (640x480, default SlamConfig with the loop gates id_interval=12,
min_kfs_since_loop=10, shipped vocabulary), so the two are like for like.
With `--noise` every frame carries the Kinect-class sensor noise of seed s
(the seed of the run): the fields are drawn on the host with numpy
(`kinect_noise_fields(s, i, ...)`) and applied by the port's
`apply_sensor_noise` on the CPU, the same noisy pixels chip_smoke.py feeds
the port on the card. `--config` adds the CLI's accuracy flags, joined by
`+` (noise-robust or dense = dense ICP; local-ba; global-ba; cell5, cell6 =
that grid cell, also cell2 and cell40; levels12 = the x1.2 scale space with
12 levels; euclidean, adaptive_euclidean = RANSAC's error model; mahal =
the Mahalanobis polish of RANSAC's winner; reassociate = GICP's nearest-
neighbour re-pairing). `--sweep` runs the 48-frame 640x480 sweep through
`PipelinedOdometry` (batch 8, the RANSAC seed = the run's seed) instead of the
tour through `SlamSystem`: chip_smoke.py's phase 4 and 11 runs; with `--slam`
the sweep goes through `SlamSystem` frame by frame instead (the loop gates
above, the shipped vocabulary): phase 11's detection configurations. `--merge` runs
chip_smoke.py's phase 12: on the 112-frame tour, session A over frames 0-60,
session B over frames 52-112 with its depth x1.05 and an equal-scale control
B' over the same frames, each with the shipped vocabulary and seed 0, then
`merge_maps(A, B)` and `merge_maps(A, B')` (max_pairs=4, min_inliers=15, as
tests/test_merge.py): the scales' medians and spread, the verified pairs and
inliers, the joint ATE; and under "pnp" the JAX package's pnp_ransac on
phase 12's PnP problems (tour pairs 20->21 and 70->71 from the port's CPU
features, `pnp_problem`), every minimal solver and refit with the same
draws as the smoke, beside the port's CPU run, and for EPnP's and the DLT's
minimal hypotheses how many clean samples give a pose within 0.1 m and how
far the arithmetic alone moves one: the smoke's `JAX_PNP`. `--detector` picks an
extractor variant of the factory (the vocabulary is then the shipped one of
its descriptor family, or none: the codebook trains online), `--subpixel`
turns on the detector's subpixel refinement, `--batch B` tracks in batches
of B frames. Only accuracy and counts are printed (with the frames that
failed and each frame's RANSAC inliers): a CPU run says nothing about speed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from rgbdslam_tpu.config import LoopConfig, SlamConfig  # noqa: E402
from rgbdslam_tpu.eval.ate import ate_rmse  # noqa: E402
from rgbdslam_tpu.geometry.camera import SYNTHETIC  # noqa: E402
from rgbdslam_tpu.io.synthetic import SyntheticDataset  # noqa: E402
from rgbdslam_tpu.loop.vocabulary import shipped_vocabulary  # noqa: E402
from rgbdslam_tpu.slam.system import SlamSystem  # noqa: E402

# SlamConfig fields by name; a dict value replaces fields of that sub-config
CONFIGS = {"base": {}, "noise-robust": {"use_dense_icp": True},
           "dense": {"use_dense_icp": True},
           "local-ba": {"use_local_ba": True}, "global-ba": {"use_global_ba": True},
           "cell5": {"extractor": {"cell_size": 5}}, "cell6": {"extractor": {"cell_size": 6}},
           "cell2": {"extractor": {"cell_size": 2}}, "cell40": {"extractor": {"cell_size": 40}},
           "levels12": {"extractor": {"scale_factor": 1.2, "num_levels": 12}},
           "euclidean": {"ransac": {"error_model": "euclidean"}},
           "adaptive_euclidean": {"ransac": {"error_model": "adaptive_euclidean"}},
           "mahal": {"ransac": {"mahalanobis_refine": True}},
           "reassociate": {"icp": {"reassociate": True}}}


def configured(cfg, names: str):
    """cfg with the +-joined CONFIGS entries applied in order."""
    for name in names.split("+"):
        for field, value in CONFIGS[name].items():
            if isinstance(value, dict):
                value = dataclasses.replace(getattr(cfg, field), **value)
            cfg = dataclasses.replace(cfg, **{field: value})
    return cfg


def sweep_slam(cfg, frames, seed: int):
    """The sweep through SlamSystem frame by frame: (timestamps, poses,
    stats) as PipelinedOdometry.run returns them."""
    system = SlamSystem(SYNTHETIC, cfg, seed=seed)
    vocab = shipped_vocabulary(cfg.detector)
    if vocab:
        system.load_vocabulary(vocab)
    for ts, gray, depth in frames:
        system.track(ts, gray, depth)
    system.finish()
    ts, poses = system.camera_trajectory()
    st = system.tracker.stats
    return ts, poses, {"failures": st.failures, "mean_inliers": st.mean_inliers,
                       "keyframes": int(system.store.count),
                       "loops_closed": int(system.loops_closed)}


def run_sweep(args, cfg) -> None:
    """The 48-frame sweep through the JAX package's PipelinedOdometry (with
    `--slam` through SlamSystem), one JSON line a seed."""
    from rgbdslam_tpu.slam.pipeline import PipelinedOdometry

    ds = SyntheticDataset(n_frames=args.frames, cam=SYNTHETIC, trajectory="sweep")
    frames = [ds.grab(i) for i in range(args.frames)]
    if args.slam:
        cfg = dataclasses.replace(cfg, loop=LoopConfig(id_interval=12, min_kfs_since_loop=10))
    for seed in args.seeds:
        if args.slam:
            ts, poses, stats = sweep_slam(cfg, frames, seed)
        else:
            ts, poses, stats = PipelinedOdometry(SYNTHETIC, cfg, batch=8, seed=seed).run(frames)
        rmse, _ = ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)
        print(json.dumps({
            "package": "rgbdslam_tpu (JAX, CPU)", "seed": seed, "trajectory": "sweep",
            "frames": args.frames, "config": args.config, "detector": args.detector,
            "slam": args.slam, "keyframes": stats.get("keyframes"),
            "loops_closed": stats.get("loops_closed"),
            "ate_rmse": round(float(rmse), 5), "failures": int(stats["failures"]),
            "mean_inliers": int(stats["mean_inliers"]),
            "finite": bool(np.isfinite(poses).all())}), flush=True)


MERGE_FRAMES = 112
MERGE_ALPHA = 1.05   # session B's depth miscalibration (tests/test_merge.py)


def run_merge(cfg, vocab) -> None:
    """Sessions A, B (depth x MERGE_ALPHA) and B' over the 112-frame tour and
    the two merges, one JSON line."""
    from rgbdslam_tpu.mapping.merge import merge_maps

    ds = SyntheticDataset(n_frames=MERGE_FRAMES, cam=SYNTHETIC, trajectory="tour")

    def session(lo, hi, depth_scale=1.0):
        system = SlamSystem(SYNTHETIC, cfg, seed=0)
        system.load_vocabulary(vocab)
        for i in range(lo, hi):
            ts, gray, depth = ds.grab(i)
            system.track(ts, gray, depth * depth_scale if depth_scale != 1.0 else depth)
        system.finish()
        return system

    sys_a = session(0, 60)
    out = {"package": "rgbdslam_tpu (JAX, CPU)", "trajectory": "tour",
           "frames": MERGE_FRAMES, "alpha": MERGE_ALPHA,
           "keyframes_a": int(sys_a.store.count),
           "failures_a": int(sys_a.tracker.stats.failures)}
    for tag, scale in (("b", MERGE_ALPHA), ("control", 1.0)):
        sys_b = session(52, MERGE_FRAMES, scale)
        res = merge_maps(sys_a, sys_b, max_pairs=4, min_inliers=15)
        Ka = sys_a.store.count
        ts_all = np.concatenate([sys_a.store.timestamps[:Ka],
                                 sys_b.store.timestamps[:sys_b.store.count]])
        order = np.argsort(ts_all)
        rmse, _ = ate_rmse(ts_all[order], res.Twc[order], ds.timestamps, ds.poses_twc)
        out.update({
            f"keyframes_{tag}": int(sys_b.store.count),
            f"failures_{tag}": int(sys_b.tracker.stats.failures),
            f"pairs_{tag}": [list(map(int, p)) for p in res.pairs],
            f"inliers_{tag}": [int(n) for n in res.inliers],
            f"median_scale_a_{tag}": float(np.median(res.scales[:Ka])),
            f"median_scale_{tag}": float(np.median(res.scales[Ka:])),
            f"std_scale_{tag}": float(np.std(res.scales[Ka:])),
            f"std_scale_all_{tag}": float(np.std(res.scales)),
            f"median_scale_all_{tag}": float(np.median(res.scales)),
            f"joint_ate_{tag}": float(rmse)})
    out["pnp"] = run_pnp(cfg)
    print(json.dumps(out), flush=True)


PNP_PAIRS = (20, 70)          # frames i -> i + 1 of the tour
PNP_VARIANTS = tuple((m, r) for m in ("p3p", "epnp", "dlt6") for r in ("ba", "epnp+ba"))
PNP_SAMPLE = {"p3p": 3, "epnp": 4, "dlt6": 6}


def pnp_problem(xyz0, uv1, idx2, valid, Twc0, i: int):
    """chip_smoke.py phase 12's 2D-3D problem on host arrays: frame i's
    points in the world (xyz0 (N, 3) camera frame, Twc0 its true pose),
    frame i + 1's undistorted keypoints uv1 matched by idx2 / valid, 30 % of
    the valid rows moved anywhere in the 640x480 image, and the (256, S)
    sample indices of every minimal solver, all drawn from seed i."""
    rng = np.random.default_rng(i)
    R, t = Twc0[:3, :3].astype(np.float32), Twc0[:3, 3].astype(np.float32)
    Xw = (xyz0 @ R.T + t).astype(np.float32)
    uv = uv1[idx2].astype(np.float32)
    rows = np.flatnonzero(valid)
    moved = rng.permutation(rows)[: int(0.3 * rows.size)]
    uv[moved] = rng.uniform([0.0, 0.0], [639.0, 479.0], (moved.size, 2)).astype(np.float32)
    draws = {m: rng.choice(rows, (256, s)) for m, s in PNP_SAMPLE.items()}
    return Xw, uv, valid.copy(), draws


def jax_pnp_ransac_drawn(cam, Xw, uv, valid, idx, minimal, refit):
    """rgbdslam_tpu's pnp_ransac (solvers/pnp.py:415-507) with its (H, S)
    sample indices given instead of drawn from a key; run_pnp checks it
    against pnp_ransac itself on the key's own draws."""
    import jax.numpy as jnp

    from rgbdslam_tpu.solvers import pnp as jpnp

    px_th, min_inliers = 3.0, 10
    any_valid = jnp.any(valid)
    uv_n = jnp.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], -1)
    if minimal == "p3p":
        rays = jnp.concatenate([uv_n, jnp.ones(uv_n.shape[:-1] + (1,), uv_n.dtype)], -1)
        rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
        T_4, ok_4 = jax.vmap(jpnp._p3p_grunert)(rays[idx], Xw[idx])
        T_h, hyp_ok = T_4.reshape(-1, 4, 4), ok_4.reshape(-1)
    else:
        fit = jax.vmap(jpnp._epnp_pose) if minimal == "epnp" else jpnp._dlt_pose
        T_h = fit(Xw[idx], uv_n[idx], valid[idx].astype(Xw.dtype))
        hyp_ok = jnp.ones((idx.shape[0],), bool)
    Xc = jnp.einsum("hij,nj->hni", T_h[:, :3, :3], Xw) + T_h[:, None, :3, 3]
    err2 = jnp.sum((jpnp._project(cam, Xc) - uv[None]) ** 2, axis=-1)
    inl_h = (err2 <= px_th * px_th) & valid[None, :] & (Xc[..., 2] > 0.05)
    best = jnp.argmax(jnp.sum(inl_h, axis=-1) * hyp_ok)
    T0, inl0 = T_h[best], inl_h[best]
    if refit == "epnp+ba":
        T_e = jpnp._epnp_pose(Xw, uv_n, (inl0 & valid).astype(Xw.dtype))
        Xc_e = jnp.einsum("ij,nj->ni", T_e[:3, :3], Xw) + T_e[:3, 3]
        err2_e = jnp.sum((jpnp._project(cam, Xc_e) - uv) ** 2, axis=-1)
        inl_e = (err2_e <= px_th * px_th) & valid & (Xc_e[..., 2] > 0.05)
        take = jnp.sum(inl_e) >= jnp.sum(inl0)
        T0, inl0 = jnp.where(take, T_e, T0), jnp.where(take, inl_e, inl0)
    T_ref, inl_ref = jpnp.motion_only_ba(cam, T0, Xw, uv, inl0 & valid)
    cnt = jnp.sum(inl_ref)
    success = (cnt >= min_inliers) & any_valid
    return (jnp.where(success, T_ref, jnp.eye(4, dtype=T_ref.dtype)), inl_ref & success,
            cnt, success)


def run_pnp(cfg) -> dict:
    """pnp_ransac of both packages on chip_smoke.py phase 12's problems
    (tour pairs 20 -> 21 and 70 -> 71, the port's CPU features, every
    minimal solver and refit, the same draws): success, inliers, the pose's
    translation error and the pose itself; the points' spread; and how the
    arithmetic moves EPnP's and the DLT's minimal hypotheses."""
    import jax.numpy as jnp
    import torch

    from rgbdslam_tpu.solvers import pnp as jpnp
    from rgbdslam_tpu_torch.frontend.frame import build_frame_features
    from rgbdslam_tpu_torch.frontend.matcher import match_frames
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC as TSYN
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset as TDataset
    from rgbdslam_tpu_torch.solvers import pnp as tpnp

    ds = TDataset(n_frames=MERGE_FRAMES, cam=TSYN, trajectory="tour", device="cpu")
    drawn = jax.jit(jax_pnp_ransac_drawn, static_argnums=(0, 5, 6))
    out = {}
    for i in PNP_PAIRS:
        f0, f1 = (build_frame_features(TSYN, *ds.grab(k)[1:], cfg.extractor)
                  for k in (i, i + 1))
        m = match_frames(f0, f1)
        Xw, uv, valid, draws = pnp_problem(f0.xyz.numpy(), f1.uv_undist.numpy(),
                                           m.idx2.long().numpy(), m.valid.numpy(),
                                           ds.poses_twc[i], i)
        T_true = np.linalg.inv(ds.poses_twc[i + 1])
        jX, juv, jvalid = jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(valid)
        rec = {"valid": int(valid.sum()), "sum_Xw": float(Xw[valid].astype(np.float64).sum()),
               "sum_uv": float(uv[valid].astype(np.float64).sum())}
        for minimal, refit in PNP_VARIANTS:
            if i == PNP_PAIRS[0]:
                # the replica against pnp_ransac itself, on the key's draws
                # (compiled as a whole, it may round apart from it)
                key = jax.random.PRNGKey(3)
                logits = jnp.where(jvalid, 0.0, -jnp.inf)
                idx_k = jax.random.categorical(key, logits, shape=(256, PNP_SAMPLE[minimal]))
                ref = jpnp.pnp_ransac(SYNTHETIC, jX, juv, jvalid, key, None, minimal, refit)
                rep = drawn(SYNTHETIC, jX, juv, jvalid, idx_k, minimal, refit)
                assert np.abs(np.asarray(ref.Tcw) - np.asarray(rep[0])).max() <= 1e-5
                assert np.array_equal(np.asarray(ref.inliers), np.asarray(rep[1]))
            Tj, inl_j, n_j, ok_j = (np.asarray(a) for a in drawn(
                SYNTHETIC, jX, juv, jvalid, jnp.asarray(draws[minimal]), minimal, refit))
            rt = tpnp.pnp_ransac(TSYN, torch.from_numpy(Xw), torch.from_numpy(uv),
                                 torch.from_numpy(valid), minimal=minimal, refit=refit,
                                 draws=torch.from_numpy(draws[minimal]))
            rec[f"{minimal}/{refit}"] = {
                "success": bool(ok_j), "inliers": int(n_j),
                "t_err": float(np.linalg.norm((np.linalg.inv(Tj) @ T_true)[:3, 3])),
                "Tcw": [float(f"{v:.7g}") for v in Tj[:3].reshape(-1)],
                "port_success": bool(rt.success), "port_inliers": int(rt.num_inliers),
                "port_minus_jax": float(np.abs(rt.Tcw.numpy() - Tj).max()),
                "inlier_rows_apart": int(np.sum(rt.inliers.numpy() != inl_j))}
        # the minimal solvers' hypotheses in float32 (JAX, LAPACK), float32
        # (the port, Jacobi) and float64 (the port, LAPACK) on the same
        # samples: how many clean samples give a pose within 0.1 m, and how
        # far the arithmetic alone moves a hypothesis
        uv_n = np.stack([(uv[:, 0] - TSYN.cx) / TSYN.fx, (uv[:, 1] - TSYN.cy) / TSYN.fy],
                        -1).astype(np.float32)
        Xc = Xw @ T_true[:3, :3].T + T_true[:3, 3]
        good = np.sum((Xc[:, :2] / Xc[:, 2:] * [TSYN.fx, TSYN.fy] + [TSYN.cx, TSYN.cy]
                       - uv) ** 2, -1) <= 9.0
        cam_true = np.linalg.inv(T_true)[:3, 3]
        rec["points_std_m"] = [float(v) for v in Xw[valid].std(axis=0)]
        for minimal, jfit, tfit in (("epnp", jax.vmap(jpnp._epnp_pose), tpnp._epnp_pose),
                                    ("dlt6", jpnp._dlt_pose, tpnp._dlt_pose)):
            idx = draws[minimal]
            args = (Xw[idx], uv_n[idx], np.ones(idx.shape, np.float32))
            hyp = {"jax_f32": np.asarray(jfit(*map(jnp.asarray, args))),
                   "port_f32": tfit(*map(torch.from_numpy, args)).numpy()}
            jacobi, tpnp.eigh_jacobi = tpnp.eigh_jacobi, torch.linalg.eigh
            try:
                hyp["port_f64_lapack"] = tfit(
                    *(torch.from_numpy(a).double() for a in args)).numpy()
            finally:
                tpnp.eigh_jacobi = jacobi
            clean = good[idx].all(-1)
            rec[f"{minimal}_minimal"] = {
                "clean_samples": int(clean.sum()),
                "within_0.1m": {k: int(np.sum(clean & (np.linalg.norm(
                    np.linalg.inv(h)[:, :3, 3] - cam_true, axis=-1) < 0.1)))
                    for k, h in hyp.items()},
                "median_apart": {
                    f"{k}-port_f64_lapack": float(np.median(np.abs(
                        hyp[k] - hyp["port_f64_lapack"]).max(axis=(1, 2))))
                    for k in ("jax_f32", "port_f32")}}
        out[f"{i}->{i + 1}"] = rec
    return out


def noisy(frames, seed: int):
    """The frames with seed `seed`'s sensor noise, as host arrays."""
    import torch

    from rgbdslam_tpu_torch.io.synthetic import apply_sensor_noise, kinect_noise_fields

    out = []
    for i, (ts, gray, depth) in enumerate(frames):
        h, w = np.shape(gray)
        g, d = apply_sensor_noise(SYNTHETIC, torch.from_numpy(np.array(gray)),
                                  torch.from_numpy(np.array(depth)),
                                  *([None] + list(kinect_noise_fields(seed, i, h, w))))
        out.append((ts, g.numpy(), d.numpy()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None,
                    help="frames of the run (128 on the tour, 48 on the sweep)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--loops", type=float, default=1.0,
                    help="revolutions of the tour (1.15: a real revisit of the start)")
    ap.add_argument("--noise", action="store_true",
                    help="Kinect-class sensor noise, seed = the run's seed")
    ap.add_argument("--config", default="base",
                    help="+-joined names of " + ", ".join(sorted(CONFIGS)))
    ap.add_argument("--detector", default="svo_fast",
                    help="extractor variant (Extractor.VARIANTS)")
    ap.add_argument("--subpixel", action="store_true",
                    help="subpixel refinement of the keypoints")
    ap.add_argument("--batch", type=int, default=0, metavar="B",
                    help="track in batches of B frames (SlamSystem.track_batch) "
                         "instead of frame by frame")
    ap.add_argument("--sweep", action="store_true",
                    help="the 48-frame sweep through PipelinedOdometry (batch 8), "
                         "default SlamConfig")
    ap.add_argument("--slam", action="store_true",
                    help="with --sweep: through SlamSystem frame by frame")
    ap.add_argument("--merge", action="store_true",
                    help="two sessions of the 112-frame tour merged by Sim(3) "
                         "(session B's depth x1.05) and the equal-scale control")
    args = ap.parse_args()
    if args.sweep:
        args.frames = args.frames or 48
        cfg = dataclasses.replace(SlamConfig(), detector=args.detector)
        run_sweep(args, configured(cfg, args.config))
        return 0
    args.frames = args.frames or 128
    cfg = configured(dataclasses.replace(
        SlamConfig(loop=LoopConfig(id_interval=12, min_kfs_since_loop=10)),
        detector=args.detector), args.config)
    if args.subpixel:
        cfg = dataclasses.replace(
            cfg, extractor=dataclasses.replace(cfg.extractor, subpixel=True))
    vocab = shipped_vocabulary(args.detector)
    if args.merge:
        run_merge(cfg, vocab)
        return 0
    ds = SyntheticDataset(n_frames=args.frames, cam=SYNTHETIC, trajectory="tour",
                          loops=args.loops)
    clean = [ds.grab(i) for i in range(args.frames)]
    for seed in args.seeds:
        frames = noisy(clean, seed) if args.noise else clean
        system = SlamSystem(SYNTHETIC, cfg, seed=seed)
        if vocab:
            system.load_vocabulary(vocab)
        failed = []      # serial: the frames; batched: each failure's batch start
        if args.batch:
            for i in range(0, len(frames), args.batch):
                before = system.tracker.stats.failures
                system.track_batch(*zip(*frames[i:i + args.batch]))
                failed += [i] * (system.tracker.stats.failures - before)
        else:
            for i, (ts, gray, depth) in enumerate(frames):
                before = system.tracker.stats.failures
                system.track(ts, gray, depth)
                if system.tracker.stats.failures > before:
                    failed.append(i)
        system.finish()
        ts_c, poses_c = system.camera_trajectory()
        rmse, info = ate_rmse(ts_c, poses_c, ds.timestamps, ds.poses_twc)
        print(json.dumps({
            "package": "rgbdslam_tpu (JAX, CPU)", "seed": seed,
            "frames": args.frames, "loops": args.loops, "noise": args.noise,
            "config": args.config, "detector": args.detector,
            "subpixel": args.subpixel, "batch": args.batch, "ate_rmse": round(float(rmse), 5),
            "keyframes": int(system.store.count),
            "loops_closed": int(system.loops_closed),
            "failures": int(system.tracker.stats.failures),
            "failed_frames": failed,
            "relocalizations": int(system.tracker.stats.relocalizations),
            "graph_vertices": int(system.graph.n_vertices),
            "graph_edges": int(system.graph.n_edges),
            "mean_inliers": int(system.tracker.stats.mean_inliers),
            "finite": bool(np.isfinite(poses_c).all()),
            "inliers": [int(f.num_inliers) for f in system.tracker.trajectory],
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
