"""Command-line entry point of the port: odometry-only pipelined tracking on a
synthetic sequence, with the JAX CLI's flag names.

  python -m rgbdslam_tpu_torch.cli --dataset synthetic:sweep --frames 48 \\
      --pipelined 8 --device cuda --out-dir /tmp/odo

Writes CameraTrajectory.txt (TUM format) and prints one JSON line with the
frame count, failures, mean inliers and, against the synthetic ground
truth, the ATE. Other modes of the JAX CLI (full SLAM, --batch, --ring,
disk datasets) raise "not yet ported".
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="RGB-D odometry (PyTorch/CUDA port)")
    p.add_argument("--dataset", required=True,
                   help="synthetic / synthetic:sweep / synthetic:orbit")
    p.add_argument("--frames", type=int, default=150, help="synthetic frame count")
    p.add_argument("--out-dir", default="slam_out")
    p.add_argument("--odometry-only", action="store_true",
                   help="tracking only; --pipelined implies it (serial "
                        "odometry without --pipelined is not yet ported)")
    p.add_argument("--batch", type=int, default=1, metavar="B",
                   help="batched full SLAM (not yet ported)")
    p.add_argument("--ring", action="store_true", help="dispatch/fetch ring (not yet ported)")
    p.add_argument("--pipelined", type=int, default=0, metavar="B",
                   help="odometry-only pipeline: B frames per host round trip")
    p.add_argument("--num-features", type=int, default=1024)
    p.add_argument("--cell-size", type=int, default=16)
    p.add_argument("--fast-threshold", type=float, default=20.0)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if not args.pipelined:
        mode = "serial odometry (--odometry-only)" if args.odometry_only else "full SLAM"
        raise NotImplementedError(
            f"not yet ported: {mode}; only the odometry-only pipelined mode "
            "(--pipelined B) runs in rgbdslam_tpu_torch")
    if args.batch > 1 or args.ring:
        raise NotImplementedError("not yet ported: --batch / --ring full-SLAM modes")
    if not args.dataset.startswith("synthetic"):
        raise NotImplementedError("not yet ported: disk datasets (synthetic only)")

    from rgbdslam_tpu_torch.config import ExtractorConfig, SlamConfig
    from rgbdslam_tpu_torch.eval.ate import ate_rmse
    from rgbdslam_tpu_torch.io import trajectory as traj_io
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.slam.pipeline import PipelinedOdometry, resolve_device

    device = resolve_device(args.device)
    traj = args.dataset.split(":", 1)[1] if ":" in args.dataset else "orbit"
    ds = SyntheticDataset(n_frames=args.frames, trajectory=traj, device=device)
    cfg = SlamConfig(extractor=ExtractorConfig(
        num_features=args.num_features, cell_size=args.cell_size,
        fast_threshold=args.fast_threshold))
    os.makedirs(args.out_dir, exist_ok=True)

    odo = PipelinedOdometry(ds.cam, cfg, batch=args.pipelined, device=device)
    t0 = time.perf_counter()
    ts, poses, stats = odo.run(ds.grab(i) for i in range(len(ds)))
    wall = time.perf_counter() - t0
    traj_io.save_tum(os.path.join(args.out_dir, "CameraTrajectory.txt"), ts, poses)
    rmse, info = ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)
    print(json.dumps({
        "frames": stats["frames"],
        "wall_s": round(wall, 3),
        "pipelined": args.pipelined,
        "device": str(device),
        "failures": stats["failures"],
        "mean_inliers": stats["mean_inliers"],
        "ate_rmse": round(rmse, 5),
        "ate_pairs": info.get("pairs", 0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
