"""Run the PyTorch port's serial full SLAM on the synthetic multi-room tour
and print its accuracy record per RANSAC seed: ATE, keyframes, loops,
failures, and how the revisit of the start was closed.

  python tools/tour_torch.py [--device cuda] [--frames 128] [--seeds 0 1 2]
                             [--proximity-radius 0.5]

The counterpart of tools/tour_reference_jax.py (same tour, same
configuration: 640x480, default SlamConfig with the loop gates
id_interval=12, min_kfs_since_loop=10, shipped vocabulary).
`--proximity-radius 0` turns the radius search off, so that the revisit can
only be closed by BoW retrieval.
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
    args = ap.parse_args()
    device = resolve_device(args.device)
    cfg = SlamConfig(loop=LoopConfig(id_interval=12, min_kfs_since_loop=10))
    if args.proximity_radius is not None:
        cfg = dataclasses.replace(cfg, pose_graph=dataclasses.replace(
            cfg.pose_graph, proximity_radius=args.proximity_radius))
    ds = SyntheticDataset(n_frames=args.frames, cam=SYNTHETIC, trajectory="tour",
                          device=device)
    frames = [ds.grab(i) for i in range(args.frames)]
    for seed in args.seeds:
        system = SlamSystem(SYNTHETIC, cfg, seed=seed, device=device)
        system.load_vocabulary(shipped_vocabulary("svo_fast"))
        for ts, gray, depth in frames:
            system.track(ts, gray, depth)
        system.finish()
        ts_c, poses_c = system.camera_trajectory()
        rmse, _ = ate_rmse(ts_c, poses_c, ds.timestamps, ds.poses_twc)
        print(json.dumps({
            "package": f"rgbdslam_tpu_torch ({device})", "seed": seed,
            "frames": args.frames, "proximity_radius": cfg.pose_graph.proximity_radius,
            "ate_rmse": round(float(rmse), 5),
            "keyframes": int(system.store.count),
            "loops_closed": int(system.loops_closed),
            "failures": int(system.tracker.stats.failures),
            "relocalizations": int(system.tracker.stats.relocalizations),
            "graph_vertices": int(system.graph.n_vertices),
            "graph_edges": int(system.graph.n_edges),
            # edges from one of the last ten keyframes to one of the first ten
            "revisit_edges": system.graph.edges_spanning(10, system.store.count - 10),
            "mean_inliers": int(system.tracker.stats.mean_inliers),
            "finite": bool(np.isfinite(poses_c).all()),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
