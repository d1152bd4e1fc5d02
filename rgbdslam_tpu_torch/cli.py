"""Command-line entry point of the port, with the JAX CLI's flag names.

Full SLAM (the default): keyframes, proximity edges, BoW loop closure and
the pose-graph solve on a synthetic sequence, on the card:

  python -m rgbdslam_tpu_torch.cli --dataset synthetic:tour --frames 128 \\
      --loop-interval 12 --out-dir /tmp/slam

On the CPU at a small size (slow at 640x480):

  python -m rgbdslam_tpu_torch.cli --dataset synthetic:orbit --frames 60 \\
      --loop-interval 12 --device cpu --width 320 --height 240 \\
      --cell-size 8 --fast-threshold 15

`--batch B` (B > 1) tracks B frames per host read, `--ring` through the
depth-2 ring (one read per frame); without either, frame by frame.
`--odometry-only` runs the bare tracker in any of these modes; `--pipelined
B` the odometry-only pipeline, B frames per host round trip. Writes
CameraTrajectory.txt and (except with --pipelined) KeyFrameTrajectory.txt in
TUM format and prints one JSON line with the counts and, against the
synthetic ground truth, the ATE. Other modes of the JAX CLI (BA, dense ICP,
disk datasets, exports) raise "not yet ported".
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
                   help="synthetic / synthetic:sweep / synthetic:orbit / synthetic:tour")
    p.add_argument("--frames", type=int, default=150, help="synthetic frame count")
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
    p.add_argument("--detector", default="svo_fast")
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
    p.add_argument("--width", type=int, default=None,
                   help="synthetic image width (default 640); the intrinsics scale with it")
    p.add_argument("--height", type=int, default=None, help="synthetic image height")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    for flag in ("--dense-icp", "--noise-robust", "--local-ba", "--global-ba",
                 "--distributed", "--save-map", "--export-ply", "--export-octomap",
                 "--export-html", "--plot", "--native-loader"):
        p.add_argument(flag, action="store_true", help="not yet ported")
    p.add_argument("--live-export", type=int, default=0, help="not yet ported")
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


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    waiting = [f for f in ("dense_icp", "noise_robust", "local_ba", "global_ba",
                           "distributed", "save_map", "export_ply", "export_octomap",
                           "export_html", "plot", "native_loader", "live_export")
               if getattr(args, f)]
    if waiting:
        raise NotImplementedError("not yet ported: --" + ", --".join(
            f.replace("_", "-") for f in waiting))

    from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, SlamConfig
    from rgbdslam_tpu_torch.device import resolve_device
    from rgbdslam_tpu_torch.eval.ate import ate_rmse
    from rgbdslam_tpu_torch.io import trajectory as traj_io
    from rgbdslam_tpu_torch.io.datasets import open_dataset

    device = resolve_device(args.device)
    ds = open_dataset(args.dataset, n_frames=args.frames, cam=_camera(args), device=device)
    cfg = SlamConfig(
        extractor=ExtractorConfig(num_features=args.num_features,
                                  cell_size=args.cell_size,
                                  fast_threshold=args.fast_threshold),
        loop=LoopConfig(id_interval=args.loop_interval),
        detector=args.detector,
        adaptive=args.adaptive,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    n = min(len(ds), args.frames)
    frames = (ds.grab(i) for i in range(n))
    result = {"frames": int(n), "device": str(device)}
    t0 = time.perf_counter()

    if args.pipelined:
        from rgbdslam_tpu_torch.slam.pipeline import PipelinedOdometry

        odo = PipelinedOdometry(ds.cam, cfg, batch=args.pipelined, device=device)
        ts_c, poses_c, stats = odo.run(frames)
        result.update(frames=stats["frames"], pipelined=args.pipelined,
                      failures=stats["failures"], mean_inliers=stats["mean_inliers"])
    else:
        from rgbdslam_tpu_torch.slam.tracking import Tracker

        system = None
        if args.odometry_only:
            tracker = Tracker(ds.cam, cfg, device=device)
        else:
            from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
            from rgbdslam_tpu_torch.slam.system import SlamSystem

            system = SlamSystem(ds.cam, cfg, device=device)
            tracker = system.tracker
            vocab = args.vocabulary
            if vocab is None:
                # the reference loads a vocabulary at startup (main.cpp:15,32)
                vocab = shipped_vocabulary(args.detector)
                if vocab:
                    print(f"vocabulary: {vocab}", file=sys.stderr)
            if vocab and vocab.lower() != "none":
                system.load_vocabulary(vocab)
        if args.batch > 1:
            chunk = []
            for item in frames:
                chunk.append(item)
                if len(chunk) == args.batch:
                    tracker.track_batch(*zip(*chunk))
                    chunk = []
            if chunk:
                tracker.track_batch(*zip(*chunk))
        elif args.ring:
            for ts, gray, depth in frames:
                tracker.track_pipelined(ts, gray, depth)
            tracker.track_pipelined_flush()
        else:
            for ts, gray, depth in frames:
                tracker.track(ts, gray, depth)
        if system is not None:
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

    result["wall_s"] = round(time.perf_counter() - t0, 3)
    traj_io.save_tum(os.path.join(args.out_dir, "CameraTrajectory.txt"), ts_c, poses_c)
    rmse, info = ate_rmse(ts_c, poses_c, ds.timestamps[:n], ds.poses_twc[:n])
    result.update(ate_rmse=round(rmse, 5), ate_pairs=info.get("pairs", 0))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
