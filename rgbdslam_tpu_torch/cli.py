"""Command-line entry point of the port, with the JAX CLI's flag names.

Full SLAM (the default): keyframes, proximity edges, BoW loop closure and
the pose-graph solve, on the card. On a TUM, ICL-NUIM or CoRBS directory
(an `associations.txt` beside the PNGs; TUM's camera from the directory
name):

  python -m rgbdslam_tpu_torch.cli --dataset /data/rgbd_dataset_freiburg1_desk \\
      --kind TUM --out-dir /tmp/slam --save-map --export-ply --export-octomap \\
      --export-html --profile

On a synthetic sequence, and on the CPU at a small size (slow at 640x480):

  python -m rgbdslam_tpu_torch.cli --dataset synthetic:tour --frames 128 \\
      --loop-interval 12 --out-dir /tmp/slam
  python -m rgbdslam_tpu_torch.cli --dataset synthetic:orbit --frames 60 \\
      --loop-interval 12 --device cpu --width 320 --height 240 \\
      --cell-size 8 --fast-threshold 15

`--batch B` (B > 1) tracks B frames per host read, `--ring` through the
depth-2 ring (one read per frame); without either, frame by frame. The
accuracy flags work in each mode: `--dense-icp` polishes every successful
estimate by dense projective ICP against the previous depth,
`--noise-robust` is the noisy-sensor preset (dense ICP with the shipped
vocabulary), `--local-ba` bundle-adjusts the last keyframes' window at each
keyframe, `--global-ba` every keyframe and landmark after each loop closure
and at the end.
`--odometry-only` runs the bare tracker in any of these modes; `--pipelined
B` the odometry-only pipeline, B frames per host round trip.
`--native-loader` reads a directory through the C++ prefetching loader
(native/framepipe.cpp), falling back to the Python loader with a message
where it does not build.

Outputs (System/Tracking.cpp:270-317): CameraTrajectory.txt and (except
with --pipelined) KeyFrameTrajectory.txt in TUM format; with the export
flags map.npz (checkpoint), map_points.ply (the keyframes' valid
observations in world coordinates), octomap.npz + octomap_voxels.ply (the
occupancy grid rebuilt from every keyframe's cloud under the final poses),
map_viewer.html and trajectory.png. One JSON line with the counts and,
against the ground truth (--eval-gt, else <dir>/groundtruth.txt, else the
synthetic poses), the ATE and RPE. `--distributed` puts the live backend
solves on a mesh over every visible device (parallel/dist_ba.py), and runs
the plain path on one device, as the JAX CLI does ("no-op on 1 device").
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="RGB-D SLAM (PyTorch/CUDA port)")
    p.add_argument("--dataset", required=True,
                   help="dataset directory, or synthetic / synthetic:sweep / "
                        "synthetic:orbit / synthetic:tour")
    p.add_argument("--kind", default="TUM", choices=["TUM", "ICL", "CORBS"],
                   help="dataset format for directory datasets")
    p.add_argument("--frames", type=int, default=150,
                   help="frame count (synthetic) or max frames (datasets)")
    p.add_argument("--out-dir", default="slam_out")
    p.add_argument("--odometry-only", action="store_true",
                   help="tracking only (no backend); --pipelined implies it")
    p.add_argument("--batch", type=int, default=1, metavar="B",
                   help="batched tracking: B frames per host read, the keyframe gate "
                        "on the device")
    p.add_argument("--ring", action="store_true",
                   help="tracking through the depth-2 ring: one host read per frame, "
                        "a keyframe's backend completing one frame late")
    p.add_argument("--pipelined", type=int, default=0, metavar="B",
                   help="odometry-only pipeline: B frames per host round trip")
    p.add_argument("--detector", default="svo_fast",
                   choices=["svo_fast", "fast", "brief", "orb", "orb2", "gftt", "star",
                            "brisk", "freak", "latch", "sift", "surf"],
                   help="extractor variant (the reference factory's types, "
                        "Features/Extractor.h:13-26)")
    p.add_argument("--adaptive", action="store_true",
                   help="ADAPTIVE detector threshold feedback")
    p.add_argument("--num-features", type=int, default=1024)
    p.add_argument("--cell-size", type=int, default=16)
    p.add_argument("--fast-threshold", type=float, default=20.0)
    p.add_argument("--vocabulary", default=None,
                   help="vocabulary .npz; default: the shipped one for the detector; "
                        "'none' trains on the first keyframes")
    p.add_argument("--loop-interval", type=int, default=100,
                   help="minimum keyframe-id distance of a loop candidate")
    p.add_argument("--save-map", action="store_true", help="map.npz checkpoint")
    p.add_argument("--export-ply", action="store_true",
                   help="map_points.ply: every keyframe's valid observations")
    p.add_argument("--export-octomap", action="store_true",
                   help="rebuild the occupancy grid (octomap equivalent: 0.08 m "
                        "log-odds voxels, hit 0.9 / miss 0.4, "
                        "Drawer/OctomapDrawer.cpp:15-79) from every keyframe's cloud "
                        "under the final poses -> octomap.npz + occupied-voxel PLY")
    p.add_argument("--export-html", action="store_true",
                   help="self-contained 3-D map viewer (map_viewer.html)")
    p.add_argument("--plot", action="store_true",
                   help="trajectory.png (needs matplotlib)")
    p.add_argument("--live-export", type=int, default=0, metavar="N",
                   help="during the run, rewrite map_viewer.html, trajectory.png, "
                        "overlay.png and (per loop closure) octomap.npz every N "
                        "keyframes (the offline analog of the reference's live "
                        "render loop, Drawer/Viewer.cpp:83-136)")
    p.add_argument("--native-loader", action="store_true",
                   help="read directory datasets through the C++ prefetching PNG loader")
    p.add_argument("--eval-gt", default=None,
                   help="ground-truth TUM file for ATE/RPE (default: "
                        "<dataset>/groundtruth.txt, or the synthetic poses)")
    p.add_argument("--profile", action="store_true",
                   help="print the per-stage timing report to stderr")
    p.add_argument("--width", type=int, default=None,
                   help="synthetic image width (default 640); the intrinsics scale with it")
    p.add_argument("--height", type=int, default=None, help="synthetic image height")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument("--dense-icp", action="store_true",
                   help="dense projective point-to-plane refinement per frame")
    p.add_argument("--noise-robust", action="store_true",
                   help="the noisy-sensor preset: dense ICP + the shipped vocabulary")
    p.add_argument("--local-ba", action="store_true",
                   help="sliding-window landmark bundle adjustment")
    p.add_argument("--global-ba", action="store_true",
                   help="full-map landmark BA after loop closures and at shutdown")
    p.add_argument("--distributed", action="store_true",
                   help="run the live backend solves (pose graph + global BA) sharded "
                        "over every visible device, the partial sums reduced in shard "
                        "order (parallel/dist_ba.py); no-op on 1 device")
    return p


def _camera(args):
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC, Camera

    if args.width is None and args.height is None:
        return SYNTHETIC
    w = args.width or SYNTHETIC.width
    h = args.height or SYNTHETIC.height
    sx, sy = w / SYNTHETIC.width, h / SYNTHETIC.height
    return Camera(SYNTHETIC.fx * sx, SYNTHETIC.fy * sy, (w - 1) / 2.0, (h - 1) / 2.0,
                  width=w, height=h)


def _frames(args, ds, n, result):
    """The (ts, gray, depth) iterator: the native loader where asked for and
    built, else the dataset's grab. Notes the loader in `result`."""
    if hasattr(ds, "rgb_files"):
        result["loader"] = ds.decoder
        if args.native_loader:
            from rgbdslam_tpu_torch.native import framepipe as fp

            if fp.native_available():
                result["loader"] = "native"
                pipe = fp.FramePipe(ds.cam.width, ds.cam.height, n_workers=2, capacity=8)
                items = [(os.path.join(ds.base_dir, ds.rgb_files[i]),
                          os.path.join(ds.base_dir, ds.depth_files[i]),
                          ds.cam.depth_factor) for i in range(n)]
                return ((ds.timestamps[tag], gray, depth)
                        for gray, depth, tag in pipe.stream(items))
            print(f"native loader unavailable ({fp.build_error()}); using python loader",
                  file=sys.stderr)
    return (ds.grab(i) for i in range(n))


def _ground_truth(args, ds, n):
    from rgbdslam_tpu_torch.io import trajectory as traj_io

    if args.eval_gt:
        return traj_io.load_tum(args.eval_gt)
    if hasattr(ds, "poses_twc"):
        return ds.timestamps[:n], ds.poses_twc[:n]
    if hasattr(ds, "ground_truth_path") and ds.ground_truth_path():
        return traj_io.load_tum(ds.ground_truth_path())
    return None


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    synthetic = args.dataset.startswith("synthetic")
    if not synthetic and (args.width or args.height):
        raise ValueError("--width/--height scale the synthetic camera only")
    if args.plot:
        from rgbdslam_tpu_torch.viz.export import plot_available

        if not plot_available():
            raise RuntimeError("--plot needs matplotlib, which is not installed")

    import numpy as np

    from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, SlamConfig
    from rgbdslam_tpu_torch.device import resolve_device
    from rgbdslam_tpu_torch.geometry import se3
    from rgbdslam_tpu_torch.io import trajectory as traj_io
    from rgbdslam_tpu_torch.io.datasets import open_dataset
    from rgbdslam_tpu_torch.utils.profiling import StageTimer

    device = resolve_device(args.device)
    if args.distributed and not args.odometry_only and not args.pipelined:
        from rgbdslam_tpu_torch.slam.system import distributed_mesh

        # the mesh the system will take, named before the loader starts
        mesh = distributed_mesh(SlamConfig(distributed=True), device)
        print(f"distributed: {mesh}" if mesh is not None else
              "distributed: one device, the plain path", file=sys.stderr)
    if synthetic:
        ds = open_dataset(args.dataset, n_frames=args.frames, cam=_camera(args),
                          device=device)
    else:
        ds = open_dataset(args.dataset, kind=args.kind)
    cfg = SlamConfig(
        extractor=ExtractorConfig(num_features=args.num_features,
                                  cell_size=args.cell_size,
                                  fast_threshold=args.fast_threshold),
        loop=LoopConfig(id_interval=args.loop_interval),
        use_dense_icp=args.dense_icp or args.noise_robust,
        use_local_ba=args.local_ba,
        use_global_ba=args.global_ba,
        detector=args.detector,
        adaptive=args.adaptive,
        distributed=args.distributed,
    )
    # the limits that stay on the card, before the loader starts
    from rgbdslam_tpu_torch.slam.tracking import check_system_config

    check_system_config(cfg, ds.cam, device)
    if args.pipelined and not args.odometry_only:
        print("--pipelined implies --odometry-only", file=sys.stderr)
        args.odometry_only = True
    os.makedirs(args.out_dir, exist_ok=True)
    n = min(len(ds), args.frames)
    result = {"frames": int(n), "device": str(device)}
    timer = StageTimer()
    frames = _frames(args, ds, n, result)
    system = None
    t0 = time.perf_counter()

    if args.pipelined:
        from rgbdslam_tpu_torch.slam.pipeline import PipelinedOdometry

        odo = PipelinedOdometry(ds.cam, cfg, batch=args.pipelined, device=device)
        with timer.stage("track"):
            ts_c, poses_c, stats = odo.run(frames)
        result.update(frames=stats["frames"], pipelined=args.pipelined,
                      failures=stats["failures"], mean_inliers=stats["mean_inliers"])
    else:
        from rgbdslam_tpu_torch.slam.tracking import Tracker

        if args.odometry_only:
            tracker = feed = Tracker(ds.cam, cfg, device=device)
        else:
            from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
            from rgbdslam_tpu_torch.slam.system import SlamSystem

            system = feed = SlamSystem(ds.cam, cfg, device=device)
            tracker = system.tracker
            vocab = args.vocabulary
            if vocab is None:
                # the reference loads a vocabulary at startup (main.cpp:15,32)
                vocab = shipped_vocabulary(args.detector)
                if vocab:
                    print(f"vocabulary: {vocab}", file=sys.stderr)
            if vocab and vocab.lower() != "none":
                system.load_vocabulary(vocab)
            if args.live_export > 0:
                system.live_export = (args.live_export, args.out_dir)

        # keyframe image retention for the export-time occupancy rebuild (the
        # reference's Frame keeps its images, Core/Frame.h:24-216)
        keeper = None
        kf_seen = kf_skipped = 0
        if args.export_octomap and system is not None:
            from rgbdslam_tpu_torch.viz.octomap_export import KeyframeImageKeeper

            keeper = KeyframeImageKeeper()

        def retain(items):
            """Offer each new keyframe's images, matched by timestamp among
            the frames just fed (a ring keyframe lands one frame late)."""
            nonlocal kf_seen, kf_skipped
            if keeper is None or not items:
                return
            by_ts = {float(it[0]): it for it in items}
            ts_max = max(by_ts)
            while kf_seen < len(tracker.keyframes):
                ts_k = float(tracker.keyframes[kf_seen][0])
                if ts_k in by_ts:
                    _, g, d = by_ts[ts_k]
                    keeper.offer(kf_seen, g, d)
                elif ts_k > ts_max:
                    break          # from a frame not delivered yet: wait for it
                else:
                    kf_skipped += 1
                    print(f"octomap: keyframe {kf_seen} (t={ts_k}) not found in its "
                          "frame chunk; excluded from the rebuild", file=sys.stderr)
                kf_seen += 1

        if args.batch > 1:
            chunk = []
            for item in frames:
                chunk.append(item)
                if len(chunk) == args.batch:
                    with timer.stage("track"):
                        feed.track_batch(*zip(*chunk))
                    retain(chunk)
                    chunk = []
            if chunk:
                with timer.stage("track"):
                    feed.track_batch(*zip(*chunk))
                retain(chunk)
        elif args.ring:
            prev = None
            for item in frames:
                with timer.stage("track"):
                    feed.track_pipelined(*item)
                retain([item] if prev is None else [prev, item])
                prev = item
            with timer.stage("track"):
                feed.track_pipelined_flush()
            if prev is not None:
                retain([prev])
        else:
            for item in frames:
                with timer.stage("track"):
                    feed.track(*item)
                retain([item])
        if system is not None:
            with timer.stage("final_optimize"):
                system.finish()
        ts_c, poses_c = tracker.camera_trajectory()
        ts_k, poses_k = tracker.keyframe_trajectory()
        traj_io.save_tum(os.path.join(args.out_dir, "KeyFrameTrajectory.txt"), ts_k, poses_k)
        result.update(keyframes=len(tracker.keyframes), failures=tracker.stats.failures,
                      mean_inliers=tracker.stats.mean_inliers)
        if tracker.stats.relocalizations:
            result["relocalizations"] = tracker.stats.relocalizations
        if system is not None:
            result.update(loops_closed=system.loops_closed,
                          graph_edges=system.graph.n_edges)

    wall = time.perf_counter() - t0
    result["wall_s"] = round(wall, 3)
    result["fps"] = round(n / wall, 2) if wall > 0 else 0.0
    traj_io.save_tum(os.path.join(args.out_dir, "CameraTrajectory.txt"), ts_c, poses_c)

    gt = _ground_truth(args, ds, n)
    if gt is not None:
        from rgbdslam_tpu_torch.eval.ate import ate_rmse, rpe

        rmse, info = ate_rmse(ts_c, poses_c, gt[0], gt[1])
        rpe_t, rpe_r = rpe(ts_c, poses_c, gt[0], gt[1])
        result.update(ate_rmse=round(rmse, 5), ate_pairs=info.get("pairs", 0),
                      rpe_trans=round(rpe_t, 5), rpe_rot=round(rpe_r, 5))

    if system is not None:
        store = system.store
        K = store.count
        if args.save_map:
            from rgbdslam_tpu_torch.utils.serialization import save_map

            with timer.stage("save_map"):
                save_map(os.path.join(args.out_dir, "map.npz"), system)
        if args.export_ply and K:
            from rgbdslam_tpu_torch.viz.export import save_ply

            # keyframe images are not kept for this export: the sparse map
            # is every keyframe's valid observations in world coordinates
            pts, cols = [], []
            for k in range(K):
                Twc = se3.inverse_np(store.poses_cw[k])
                ok = store.obs_valid[k]
                pts.append(store.xyz[k][ok] @ Twc[:3, :3].T + Twc[:3, 3])
                cols.append(store.intensity[k][ok])
            with timer.stage("export_ply"):
                save_ply(os.path.join(args.out_dir, "map_points.ply"),
                         np.concatenate(pts), np.concatenate(cols))
        if keeper is not None and keeper.images:
            from rgbdslam_tpu_torch.mapping.occupancy import occupied_voxels, save_grid
            from rgbdslam_tpu_torch.viz.export import save_ply
            from rgbdslam_tpu_torch.viz.octomap_export import build_occupancy_from_keyframes

            with timer.stage("octomap"):
                grid = build_occupancy_from_keyframes(ds.cam, keeper.images, store.poses_cw,
                                                      cfg.keyframe, device=device)
                save_grid(os.path.join(args.out_dir, "octomap.npz"), grid)
                centers, cols = occupied_voxels(grid)
                if len(centers):
                    save_ply(os.path.join(args.out_dir, "octomap_voxels.ply"), centers, cols)
            result.update(octomap_voxels=int(len(centers)),
                          octomap_keyframes=len(keeper.images),
                          octomap_kf_skipped=kf_skipped)
        if args.export_html:
            from rgbdslam_tpu_torch.viz.export import save_html_viewer

            pw, inten = system.landmarks.world_points()
            poses_twc = se3.inverse_np(store.poses_cw[:K]) if K else None
            with timer.stage("export_html"):
                save_html_viewer(os.path.join(args.out_dir, "map_viewer.html"), pw, inten,
                                 poses_twc)
    if args.plot:
        from rgbdslam_tpu_torch.viz.export import plot_trajectories

        trajs, labels = [poses_c], ["estimate"]
        if gt is not None:
            trajs.append(gt[1])
            labels.append("ground truth")
        plot_trajectories(os.path.join(args.out_dir, "trajectory.png"), trajs, labels)
    if args.profile:
        print(timer.report(), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
