"""Run the PyTorch port's serial full SLAM on the synthetic multi-room tour
and print its accuracy record per RANSAC seed: ATE, keyframes, loops,
failures (and the frames that failed), each frame's RANSAC inliers, and how
the revisit of the start was closed.

  python tools/tour_torch.py [--device cuda] [--frames 128] [--seeds 0 1 2]
                             [--proximity-radius 0.5]
  python tools/tour_torch.py --loops 1.15 --detector sift --seeds 0 1 2
  python tools/tour_torch.py --loops 1.15 --detector orb --seeds 0 --ring

The counterpart of tools/tour_reference_jax.py (same tour, same
configuration: 640x480, default SlamConfig with the loop gates
id_interval=12, min_kfs_since_loop=10, the shipped vocabulary of the
detector's family where there is one, else online training).
`--proximity-radius 0` turns the radius search off, so that the revisit can
only be closed by BoW retrieval. `--detector`, `--subpixel` and `--loops`
are the JAX tool's; `--ring` tracks through the ring
(`track_pipelined`: a frame's failure is read a frame late). The RANSAC draws come from a torch.Generator on the
device: a seed's draws on the card are not its draws on the CPU, and
neither are the JAX package's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from rgbdslam_tpu_torch.config import LoopConfig, SlamConfig  # noqa: E402
from rgbdslam_tpu_torch.device import resolve_device  # noqa: E402
from rgbdslam_tpu_torch.eval.ate import ate_rmse  # noqa: E402
from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC  # noqa: E402
from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset  # noqa: E402
from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary  # noqa: E402
from rgbdslam_tpu_torch.slam.system import SlamSystem  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--proximity-radius", type=float, default=None)
    ap.add_argument("--loops", type=float, default=1.0,
                    help="revolutions of the tour (1.15: a real revisit of the start)")
    ap.add_argument("--detector", default="svo_fast",
                    help="extractor variant (Extractor.VARIANTS)")
    ap.add_argument("--subpixel", action="store_true",
                    help="subpixel refinement of the keypoints")
    ap.add_argument("--ring", action="store_true",
                    help="track through the ring (track_pipelined) instead of track")
    args = ap.parse_args()
    device = resolve_device(args.device)
    cfg = dataclasses.replace(
        SlamConfig(loop=LoopConfig(id_interval=12, min_kfs_since_loop=10)),
        detector=args.detector)
    if args.subpixel:
        cfg = dataclasses.replace(
            cfg, extractor=dataclasses.replace(cfg.extractor, subpixel=True))
    if args.proximity_radius is not None:
        cfg = dataclasses.replace(cfg, pose_graph=dataclasses.replace(
            cfg.pose_graph, proximity_radius=args.proximity_radius))
    vocab = shipped_vocabulary(args.detector)
    ds = SyntheticDataset(n_frames=args.frames, cam=SYNTHETIC, trajectory="tour",
                          loops=args.loops, device=device)
    frames = [ds.grab(i) for i in range(args.frames)]
    for seed in args.seeds:
        system = SlamSystem(SYNTHETIC, cfg, seed=seed, device=device)
        if vocab:
            system.load_vocabulary(vocab)
        failed = []
        step = system.track_pipelined if args.ring else system.track
        for i, (ts, gray, depth) in enumerate(frames):
            before = system.tracker.stats.failures
            step(ts, gray, depth)
            if system.tracker.stats.failures > before:
                failed.append(i - int(args.ring))
        if args.ring:
            before = system.tracker.stats.failures
            system.track_pipelined_flush()
            failed += [len(frames) - 1] * (system.tracker.stats.failures - before)
        system.finish()
        ts_c, poses_c = system.camera_trajectory()
        rmse, _ = ate_rmse(ts_c, poses_c, ds.timestamps, ds.poses_twc)
        print(json.dumps({
            "package": f"rgbdslam_tpu_torch ({device})", "seed": seed,
            "frames": args.frames, "loops": args.loops, "detector": args.detector,
            "subpixel": args.subpixel, "ring": args.ring, "proximity_radius": cfg.pose_graph.proximity_radius,
            "ate_rmse": round(float(rmse), 5),
            "keyframes": int(system.store.count),
            "loops_closed": int(system.loops_closed),
            "failures": int(system.tracker.stats.failures),
            "failed_frames": failed,
            "relocalizations": int(system.tracker.stats.relocalizations),
            "graph_vertices": int(system.graph.n_vertices),
            "graph_edges": int(system.graph.n_edges),
            # edges from one of the last ten keyframes to one of the first ten
            "revisit_edges": system.graph.edges_spanning(10, system.store.count - 10),
            "mean_inliers": int(system.tracker.stats.mean_inliers),
            "finite": bool(np.isfinite(poses_c).all()),
            "inliers": [int(f.num_inliers) for f in system.tracker.trajectory],
            "tracked_t": [[round(float(x), 5) for x in f.Tcw[:3, 3]]
                          for f in system.tracker.trajectory],
            "ref_kf": [int(f.ref_kf_index) for f in system.tracker.trajectory],
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
